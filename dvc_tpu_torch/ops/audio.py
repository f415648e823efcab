"""Waveform resampling (port of dvc_tpu/ops/audio.py:57-103).

Rational polyphase resampling by up/down with a windowed-sinc filter: the
role of librosa.resample at reference preprocessing/encoder/audio.py:44.
dvc_tpu writes it as one ``conv_general_dilated`` whose input dilation is
the upsample; here the upsample is explicit zero-stuffing followed by a
strided ``F.conv1d``, which is the same sum.  The rest of dvc_tpu's audio
ops (volume normalization, the VAD trim, mu-law) come with preprocessing.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _sinc_kernel(up: int, down: int, num_zeros: int = 16, rolloff: float = 0.945) -> np.ndarray:
    """Windowed-sinc polyphase filter for rational resampling by up/down
    (dvc_tpu's, bit for bit)."""
    cutoff = rolloff * 0.5 / max(up, down)
    half = int(np.ceil(num_zeros / (2 * cutoff)))
    n = np.arange(-half, half + 1, dtype=np.float64)
    x = 2 * cutoff * n
    sinc = np.sinc(x)
    win = np.hanning(len(n) + 2)[1:-1]
    kernel = 2 * cutoff * sinc * win * up
    return kernel.astype(np.float32)


def resample_poly(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """(..., T) -> (..., ceil(T * up / down)) float32, on the waveform's
    device, with up/down = target_sr/orig_sr in lowest terms."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    kernel = torch.from_numpy(_sinc_kernel(up, down)).to(wav.device)
    pad = kernel.numel() // 2

    batch_shape = wav.shape[:-1]
    t = wav.shape[-1]
    x = wav.to(torch.float32).reshape(-1, 1, t)
    out_len = -(-t * up // down)
    # output o reads [o*down - pad, o*down + pad] of the ((t-1)*up + 1)-long
    # zero-stuffed signal: the right padding must reach the last output's
    # taps, which the symmetric filter half alone does not for some
    # length/ratio pairs (dvc_tpu/ops/audio.py:86-91)
    stuffed_len = (t - 1) * up + 1
    pad_r = max(pad, (out_len - 1) * down + pad + 1 - stuffed_len)
    stuffed = x.new_zeros(x.shape[0], 1, pad + stuffed_len + pad_r)
    stuffed[..., pad:pad + stuffed_len:up] = x
    y = F.conv1d(stuffed, kernel.view(1, 1, -1), stride=down)
    return y.reshape(batch_shape + (-1,))[..., :out_len]
