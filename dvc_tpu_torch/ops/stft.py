"""STFT magnitude with lws-compatible framing (port of dvc_tpu/ops/stft.py).

lws pads (fsize - fshift) on the left and (fsize - fshift + r) on the right so
that M frames of size fsize at hop fshift tile the padded signal exactly
(reference preprocessing/utils.py:89-107); the analysis window is lws'
default periodic sqrt(hann).  Framing is ``Tensor.unfold`` and the FFT is
``torch.fft.rfft`` on whatever device the waveform lives on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.config import AudioConfig
from dvc_tpu_torch.utils.device import device_constant


def num_frames(length: int, fsize: int, fshift: int) -> int:
    """Frame count of the lws spectrogram (reference preprocessing/utils.py:89-97)."""
    pad = fsize - fshift
    if length % fshift == 0:
        return (length + pad * 2 - fsize) // fshift + 1
    return (length + pad * 2 - fsize) // fshift + 2


def pad_lr(length: int, fsize: int, fshift: int) -> tuple[int, int]:
    """Left/right padding lws uses internally (reference preprocessing/utils.py:100-107)."""
    m = num_frames(length, fsize, fshift)
    pad = fsize - fshift
    t = length + 2 * pad
    r = (m - 1) * fshift + fsize - t
    return pad, pad + r


@functools.lru_cache(maxsize=8)
def _window(kind: str, fsize: int) -> np.ndarray:
    # periodic hann, computed in float64 and rounded once, as dvc_tpu does
    n = np.arange(fsize, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fsize)
    if kind == "hann":
        w = hann
    elif kind == "sqrt_hann":
        w = np.sqrt(hann)
    elif kind == "rect":
        w = np.ones(fsize)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return w.astype(np.float32)


def frame_signal(wav: torch.Tensor, fsize: int, fshift: int) -> torch.Tensor:
    """(..., T) -> (..., M, fsize) frames after lws padding."""
    left, right = pad_lr(wav.shape[-1], fsize, fshift)
    padded = F.pad(wav, (left, right))
    return padded.unfold(-1, fsize, fshift)


def stft_magnitude(wav: torch.Tensor, cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """|STFT|, (..., T) -> (..., M, n_fft//2+1), float32."""
    frames = frame_signal(wav.to(torch.float32), cfg.fft_size, cfg.hop_size)
    win = device_constant(_window, (cfg.window, cfg.fft_size), wav.device)
    spec = torch.fft.rfft(frames * win, n=cfg.fft_size, dim=-1)
    return spec.abs().to(torch.float32)
