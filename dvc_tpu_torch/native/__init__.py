"""ctypes bindings for the native C++ DSP engine (dvc_dsp.cpp), the port's
copy of dvc_tpu/native/__init__.py.

The engine builds with g++ into build/native/ at first use (_build.py).
Unlike dvc_tpu's bindings there is no ``available()`` and no fallback: a
library that does not build or load raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from dvc_tpu_torch.native._build import load

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_long)
_I = ctypes.POINTER(ctypes.c_int)


def _declare(lib: ctypes.CDLL) -> None:
    lib.dvc_melspectrogram.restype = ctypes.c_int
    lib.dvc_melspectrogram.argtypes = [
        _F, ctypes.c_long, _F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.dvc_num_frames.restype = ctypes.c_int
    lib.dvc_num_frames.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.dvc_resample.restype = ctypes.c_long
    lib.dvc_resample.argtypes = [_F, ctypes.c_long, _F, ctypes.c_int, ctypes.c_int]
    lib.dvc_energy_vad.restype = ctypes.c_long
    lib.dvc_energy_vad.argtypes = [_F, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_double]
    lib.dvc_dtw_path.restype = ctypes.c_long
    lib.dvc_dtw_path.argtypes = [_D, ctypes.c_long, ctypes.c_long, _I, _I]
    lib.dvc_melspectrogram_batch.restype = ctypes.c_int
    lib.dvc_melspectrogram_batch.argtypes = [
        _F, _L, _L, ctypes.c_int, _F, _L, _I, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]


def _lib() -> ctypes.CDLL:
    return load("dvc_dsp", _declare)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F)


def melspectrogram(wav: np.ndarray, sample_rate: int = 16_000,
                   fft_size: int = 1024, hop_size: int = 256,
                   num_mels: int = 80, fmin: float = 90.0, fmax: float = 7600.0,
                   min_level_db: float = -100.0,
                   ref_level_db: float = 16.0) -> np.ndarray:
    """(T,) float wav -> (num_mels, frames) normalized mel, C++ path."""
    lib = _lib()
    wav = np.ascontiguousarray(wav, np.float32)
    m = lib.dvc_num_frames(len(wav), fft_size, hop_size)
    out = np.empty((num_mels, m), np.float32)
    got = lib.dvc_melspectrogram(_fp(wav), len(wav), _fp(out), sample_rate,
                                 fft_size, hop_size, num_mels, fmin, fmax,
                                 min_level_db, ref_level_db)
    if got != m:
        raise RuntimeError(f"native melspectrogram failed ({got})")
    return out


def melspectrogram_batch(wavs: list[np.ndarray], n_threads: int = 0,
                         **kw) -> list[np.ndarray]:
    """Thread-pooled batched mel extraction (one C call for the whole list)."""
    if not wavs:
        return []
    lib = _lib()
    p = dict(sample_rate=16_000, fft_size=1024, hop_size=256, num_mels=80,
             fmin=90.0, fmax=7600.0, min_level_db=-100.0, ref_level_db=16.0)
    p.update(kw)
    n_threads = n_threads or (os.cpu_count() or 1)

    lengths = np.array([len(w) for w in wavs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    concat = np.ascontiguousarray(np.concatenate(
        [np.asarray(w, np.float32) for w in wavs]))
    frames = np.array([lib.dvc_num_frames(int(n), p["fft_size"], p["hop_size"])
                       for n in lengths], np.int32)
    sizes = frames.astype(np.int64) * p["num_mels"]
    out_offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.empty(int(sizes.sum()), np.float32)
    frames_out = np.zeros(len(wavs), np.int32)

    ret = lib.dvc_melspectrogram_batch(
        _fp(concat), offsets.ctypes.data_as(_L), lengths.ctypes.data_as(_L), len(wavs),
        _fp(out), out_offsets.ctypes.data_as(_L), frames_out.ctypes.data_as(_I), n_threads,
        p["sample_rate"], p["fft_size"], p["hop_size"], p["num_mels"],
        p["fmin"], p["fmax"], p["min_level_db"], p["ref_level_db"])
    if ret != 0:
        raise RuntimeError("native batch melspectrogram failed")
    return [out[o:o + s].reshape(p["num_mels"], f)
            for o, s, f in zip(out_offsets, sizes, frames_out)]


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    lib = _lib()
    wav = np.ascontiguousarray(wav, np.float32)
    out_len = int(np.ceil(len(wav) * target_sr / orig_sr))
    out = np.empty(out_len + 8, np.float32)
    got = lib.dvc_resample(_fp(wav), len(wav), _fp(out), orig_sr, target_sr)
    if got < 0:
        raise RuntimeError("native resample failed")
    return out[:out_len]


def dtw_path(dist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact DTW path over a dense (n, m) distance matrix: the O(n m)
    accumulation and the backtrack in C++."""
    lib = _lib()
    dist = np.ascontiguousarray(dist, np.float64)
    n, m = dist.shape
    px = np.empty(n + m, np.int32)
    py = np.empty(n + m, np.int32)
    got = lib.dvc_dtw_path(dist.ctypes.data_as(_D), n, m, px.ctypes.data_as(_I),
                           py.ctypes.data_as(_I))
    if got < 0:
        raise RuntimeError("native DTW failed")
    return px[:got].astype(np.int64), py[:got].astype(np.int64)


def energy_vad(wav: np.ndarray, sample_rate: int = 16_000, window_ms: int = 30,
               threshold_db: float = -48.0) -> np.ndarray:
    lib = _lib()
    wav = np.ascontiguousarray(wav, np.float32)
    spw = window_ms * sample_rate // 1000
    mask = np.zeros(len(wav) // spw, np.uint8)
    lib.dvc_energy_vad(_fp(wav), len(wav), mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       sample_rate, window_ms, threshold_db)
    return mask.astype(bool)
