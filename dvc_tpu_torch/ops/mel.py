"""Mel spectrogram: Slaney filterbank, dB conversion, [0, 1] normalization.

Port of dvc_tpu/ops/mel.py.  Reference behaviour
(preprocessing/utils.py:68-143):
    melspectrogram(y) = normalize(amp_to_db(mel_basis @ |STFT(y)|) - ref_level_db)
with mel_basis = librosa.filters.mel(sr, n_fft, fmin=90, fmax=7600, n_mels=80)
rebuilt from its defining math (Slaney mel scale, area normalization).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dvc_tpu_torch.config import AudioConfig
from dvc_tpu_torch.ops.stft import stft_magnitude

# --- Slaney mel scale (linear below 1 kHz, log above) -----------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(log_region, _MIN_LOG_MEL
                    + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mels)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int = 16_000, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 90.0, fmax: float = 7600.0) -> np.ndarray:
    """(n_mels, n_fft//2+1) Slaney-normalized triangular mel filterbank
    (librosa.filters.mel with its defaults, reference preprocessing/utils.py:124)."""
    if fmax > sample_rate / 2:
        raise ValueError("fmax above Nyquist")
    n_freq = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freq, dtype=np.float64)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# --- dB / normalization (preprocessing/utils.py:129-143) ---------------------

def amp_to_db(x: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    min_level = math.exp(min_level_db / 20.0 * math.log(10.0))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_mel(s_db: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    return torch.clamp((s_db - min_level_db) / -min_level_db, 0.0, 1.0)


def denormalize_mel(s: torch.Tensor, min_level_db: float = -100.0) -> torch.Tensor:
    return torch.clamp(s, 0.0, 1.0) * -min_level_db + min_level_db


def melspectrogram(wav: torch.Tensor, cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """Mel spectrogram, (..., T_samples) -> (..., n_mels, T_frames), on the
    waveform's device."""
    mag = stft_magnitude(wav, cfg)  # (..., frames, n_freq)
    basis = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.fft_size,
                                            cfg.num_mels, cfg.fmin,
                                            cfg.fmax)).to(mag.device)
    mel = torch.matmul(mag, basis.T)  # (..., frames, n_mels)
    s_db = amp_to_db(mel, cfg.min_level_db) - cfg.ref_level_db
    return normalize_mel(s_db, cfg.min_level_db).transpose(-1, -2)
