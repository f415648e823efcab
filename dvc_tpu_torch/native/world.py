"""ctypes bindings for the native WORLD engine (dvc_world.cpp), the port's
copy of dvc_tpu/native/world.py.

harvest() and d4c() are the algorithm-faithful equivalents of
pyworld.harvest and pyworld.d4c (reference
preprocessing/WORLD_processing.py:33-35), implemented from the published
Morise papers, and synthesize() is the WORLD-faithful synthesizer in the
role of pyworld.synthesize (WORLD_processing.py:99-106).  Built into
build/native/ at first use; a failed build raises (dvc_tpu falls back to a
JAX NCCF tracker and its device synthesis then, with other numbers).  DIO
is not bound: no command of dvc_tpu reaches it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dvc_tpu_torch.native._build import load

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)


def _declare(lib: ctypes.CDLL) -> None:
    lib.dvc_harvest_frames.restype = ctypes.c_int
    lib.dvc_harvest_frames.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_double]
    lib.dvc_harvest.restype = ctypes.c_int
    lib.dvc_harvest.argtypes = [_F, ctypes.c_long, ctypes.c_int, ctypes.c_double,
                                ctypes.c_double, ctypes.c_double, _D]
    lib.dvc_d4c.restype = ctypes.c_int
    lib.dvc_d4c.argtypes = [_F, ctypes.c_long, ctypes.c_int, _D, ctypes.c_int,
                            ctypes.c_double, ctypes.c_int, ctypes.c_double, _D]
    lib.dvc_synthesis.restype = ctypes.c_int
    lib.dvc_synthesis.argtypes = [_D, ctypes.c_int, _D, _D, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_long, ctypes.c_ulonglong, _D]


def _lib() -> ctypes.CDLL:
    return load("dvc_world", _declare)


def harvest(wav: np.ndarray, fs: int, frame_period: float = 5.0,
            f0_floor: float = 71.0, f0_ceil: float = 800.0
            ) -> tuple[np.ndarray, np.ndarray]:
    """(T,) waveform -> (f0, timeaxis), both (N,) float64 at frame_period ms
    (pyworld.harvest contract: f0 == 0 for unvoiced frames)."""
    lib = _lib()
    if not (frame_period > 0.0 and 0.0 < f0_floor < f0_ceil):
        raise RuntimeError(
            f"invalid harvest parameters: frame_period={frame_period}, "
            f"f0 band [{f0_floor}, {f0_ceil}]")
    wav = np.ascontiguousarray(wav, np.float32)
    n_out = lib.dvc_harvest_frames(len(wav), fs, frame_period)
    f0 = np.zeros(n_out, np.float64)
    got = lib.dvc_harvest(wav.ctypes.data_as(_F), len(wav), fs, frame_period,
                          f0_floor, f0_ceil, f0.ctypes.data_as(_D))
    if got != n_out:
        raise RuntimeError(f"native harvest failed ({got})")
    timeaxis = np.arange(n_out, dtype=np.float64) * frame_period / 1000.0
    return f0, timeaxis


def d4c(wav: np.ndarray, f0: np.ndarray, fs: int, frame_period: float,
        fft_size: int, threshold: float = 0.85) -> np.ndarray:
    """Band aperiodicity (N, fft_size//2+1) on the CheapTrick spectral grid
    (pyworld.d4c contract).  ``threshold`` is the LoveTrain voicing cutoff
    (pyworld's D4COption.threshold, default 0.85): voiced frames whose
    0.1-4 kHz share of 0.1-7.9 kHz power is at or below it are forced fully
    aperiodic; 0 disables the override."""
    lib = _lib()
    wav = np.ascontiguousarray(wav, np.float32)
    f0 = np.ascontiguousarray(f0, np.float64)
    n_frames = len(f0)
    out = np.zeros((n_frames, fft_size // 2 + 1), np.float64)
    got = lib.dvc_d4c(wav.ctypes.data_as(_F), len(wav), fs, f0.ctypes.data_as(_D), n_frames,
                      frame_period, fft_size, threshold, out.ctypes.data_as(_D))
    if got != 0:
        raise RuntimeError(f"native d4c failed ({got})")
    return out


def synthesize(f0: np.ndarray, sp: np.ndarray, ap: np.ndarray, fs: int,
               frame_period: float = 5.0, y_length: int | None = None,
               seed: int = 0) -> np.ndarray:
    """WORLD-faithful synthesis (pyworld.synthesize contract): f0 (N,), sp
    and ap (N, fft_size//2+1), the CheapTrick power envelope and the D4C
    aperiodicity -> float32 waveform of ``y_length`` samples (one frame
    period a frame by default).  Minimum-phase responses at each glottal
    pulse, placed at fractional-pitch instants, with the periodic and
    aperiodic power split per bin; deterministic for a seed at any thread
    count."""
    lib = _lib()
    sp = np.ascontiguousarray(sp, np.float64)
    ap = np.ascontiguousarray(ap, np.float64)
    f0 = np.ascontiguousarray(f0, np.float64)
    n_frames, n_freq = sp.shape
    if ap.shape != sp.shape or len(f0) != n_frames:
        raise ValueError(f"shape mismatch: f0 {f0.shape}, sp {sp.shape}, ap {ap.shape}")
    if y_length is None:
        y_length = int(n_frames * frame_period * fs / 1000.0)
    y = np.zeros(y_length, np.float64)
    got = lib.dvc_synthesis(f0.ctypes.data_as(_D), n_frames, sp.ctypes.data_as(_D),
                            ap.ctypes.data_as(_D), 2 * (n_freq - 1), fs, frame_period,
                            y_length, seed, y.ctypes.data_as(_D))
    if got != 0:
        raise RuntimeError(f"native synthesis failed ({got})")
    return y.astype(np.float32)
