"""ctypes bindings for the native FLAC decoder (dvc_flac.cpp), the port's
copy of dvc_tpu/native/flac.py.

Role parity: the reference reads LibriSpeech flac through librosa/soundfile
(preprocessing/encoder/preprocess.py:141).  Built into build/native/ at
first use; a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dvc_tpu_torch.native._build import load


def _declare(lib: ctypes.CDLL) -> None:
    lib.dvc_flac_info.restype = ctypes.c_int
    lib.dvc_flac_info.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long)]
    lib.dvc_flac_decode.restype = ctypes.c_long
    lib.dvc_flac_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """FLAC file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    lib = load("dvc_flac", _declare)
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    buf = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    total = ctypes.c_long()
    if lib.dvc_flac_info(buf, len(data), ctypes.byref(sr), ctypes.byref(ch),
                         ctypes.byref(total)) != 0:
        raise ValueError(f"{path}: not a decodable FLAC file")
    # Start from a file-size heuristic even when the header states a total:
    # a corrupt STREAMINFO can claim up to 2^36 samples, while the
    # grow-and-retry loop below reaches any real size in a few doublings.
    # The claimed total only caps the growth.
    claimed = int(total.value) if total.value > 0 else 1 << 30
    capacity = min(claimed, max(8 * len(data) + 65536, 1 << 16))
    while True:
        out = np.zeros(capacity, np.float32)
        got = lib.dvc_flac_decode(
            buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), capacity)
        if got < 0:
            raise ValueError(f"{path}: FLAC frame decode failed")
        # a full buffer may mean constant-subframe compression beat the
        # heuristic: grow and retry rather than silently truncate
        if got < capacity or capacity >= min(claimed, 1 << 30):
            return out[:got], int(sr.value)
        capacity = min(capacity * 4, claimed, 1 << 30)
