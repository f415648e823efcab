"""What the probes share: the ring geometry, the ctypes binding's error
check and bench()'s timing."""

from __future__ import annotations

import ctypes
import time
from typing import Callable

import numpy as np
import torch

VP = ctypes.c_void_p
I32 = ctypes.c_int


def geometry(layers: int) -> tuple[np.ndarray, np.ndarray]:
    """(dil, offs) of the probes' ring: dilation 2^(l mod 6), each layer a
    segment of 2d slots (tools/bench_taps.py:21-22)."""
    dil = np.array([2 ** (i % 6) for i in range(layers)], np.int32)
    return dil, offsets(dil)


def offsets(dil: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(2 * dil)[:-1]]).astype(np.int32)


def taps_of(t: int, d: int, off: int) -> tuple[int, int]:
    """Ring slots (x_{t-2d}, x_{t-d}) of a layer at step t; the first is
    the one the layer input overwrites."""
    wp = t % (2 * d)
    return off + wp, off + (wp + d) % (2 * d)


def dil_array(dil) -> np.ndarray:
    dil = np.ascontiguousarray(dil, np.int32)
    if dil.ndim != 1 or len(dil) == 0 or (dil <= 0).any():
        raise ValueError(f"dil must be a non-empty 1-D array of positive ints, got {dil}")
    return dil


def check(lib: ctypes.CDLL, err: int, what: str, error_string: str) -> None:
    if err != 0:
        msg = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def cuda_checked(t: torch.Tensor, name: str, dev: torch.device, dtype: torch.dtype) -> int:
    """t's data pointer after checking that it is a contiguous, 16-byte
    aligned tensor of ``dtype`` on ``dev``."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")
    return t.data_ptr()


def time_best(fn: Callable[[], object], device: torch.device,
              reps: int = 3) -> tuple[float, float]:
    """(seconds of the first call, best of ``reps`` calls after it), as the
    JAX probes' bench does (one warm call, then the best of 3).  On a card
    each call is timed between two CUDA events and synchronised; on the CPU
    by the host clock around the call and a fetch of its result."""
    def once() -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = fn()
        float(out.sum())
        return time.perf_counter() - t0

    first = once()
    return first, min(once() for _ in range(reps))


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
