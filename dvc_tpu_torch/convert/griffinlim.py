"""Griffin-Lim mel inversion: the checkpoint-free default vocoder (port of
dvc_tpu/convert/griffinlim.py).

Role of reference preprocessing/processing.py:133-141 (``simple_inverse``):
the [0, 1] mel goes back through the normalization and dB chain of
ops/mel.py, through the pseudo-inverse of the mel filterbank (clipped at
0) to a linear magnitude, and Griffin-Lim iterations recover a phase from
a zero-phase start, so the result is deterministic.  The STFT is
``torch.fft.rfft`` over the port's lws framing (ops/stft.py), the inverse
``torch.fft.irfft`` with an overlap-add by ``F.fold``; everything batches
over leading dims and runs on the magnitude's device (cuFFT on a card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.config import AudioConfig
from dvc_tpu_torch.ops.mel import db_to_amp, denormalize_mel, mel_filterbank
from dvc_tpu_torch.ops.stft import _window, frame_signal, num_frames, pad_lr
from dvc_tpu_torch.utils.device import device_constant, resolve_device


@functools.lru_cache(maxsize=8)
def _mel_pinv(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
              fmax: float) -> np.ndarray:
    """(n_freq, n_mels) pseudo-inverse of the mel filterbank."""
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return np.linalg.pinv(basis.astype(np.float64)).astype(np.float32)


def mel_to_stft_magnitude(mel_norm: torch.Tensor,
                          cfg: AudioConfig = AudioConfig()) -> torch.Tensor:
    """[0, 1]-normalized (..., n_mels, T) mel -> (..., T, n_freq) |STFT|, in
    the mel's floating type, at least float32."""
    dt = torch.promote_types(mel_norm.dtype, torch.float32)
    s_db = denormalize_mel(mel_norm.to(dt), cfg.min_level_db) + cfg.ref_level_db
    mel_amp = db_to_amp(s_db)  # (..., n_mels, T)
    pinv = device_constant(_mel_pinv, (cfg.sample_rate, cfg.fft_size, cfg.num_mels,
                                       cfg.fmin, cfg.fmax), mel_amp.device, dt)
    mag = torch.einsum("fm,...mt->...tf", pinv, mel_amp)
    return torch.clamp(mag, min=0.0)


def _stft_complex(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    frames = frame_signal(wav, cfg.fft_size, cfg.hop_size)
    win = device_constant(_window, (cfg.window, cfg.fft_size), wav.device)
    return torch.fft.rfft(frames * win, n=cfg.fft_size, dim=-1)


@functools.lru_cache(maxsize=64)
def _overlap_norm(kind: str, fsize: int, fshift: int, m: int) -> np.ndarray:
    """Overlap-added squared window of m frames, floored at 1e-8 (constant
    except at the edges)."""
    total = (m - 1) * fshift + fsize
    idx = (np.arange(m)[:, None] * fshift + np.arange(fsize)[None, :]).reshape(-1)
    wsq = np.zeros(total, np.float32)
    np.add.at(wsq, idx, np.tile(np.asarray(_window(kind, fsize)) ** 2, m))
    return np.maximum(wsq, 1e-8)


def istft(spec: torch.Tensor, length: int, cfg: AudioConfig = AudioConfig()
          ) -> torch.Tensor:
    """Overlap-add inverse of the ops/stft framing.

    spec: (..., M, n_freq) complex; returns (..., length) float32 such that
    istft(stft(x)) ~= x for the sqrt-hann analysis/synthesis pair."""
    fsize, fshift = cfg.fft_size, cfg.hop_size
    m = spec.shape[-2]
    win = device_constant(_window, (cfg.window, fsize), spec.device)
    frames = torch.fft.irfft(spec, n=fsize, dim=-1) * win  # (..., M, fsize)

    left, _right = pad_lr(length, fsize, fshift)
    total = (m - 1) * fshift + fsize
    batch_shape = frames.shape[:-2]
    cols = frames.reshape(-1, m, fsize).transpose(1, 2)    # (N, fsize, M)
    out = F.fold(cols, output_size=(1, total), kernel_size=(1, fsize),
                 stride=(1, fshift)).reshape(batch_shape + (total,))
    norm = device_constant(_overlap_norm, (cfg.window, fsize, fshift, m), out.device)
    return (out / norm)[..., left:left + length]


def _griffin_lim(mag: torch.Tensor, length: int, n_iter: int,
                 cfg: AudioConfig) -> torch.Tensor:
    """(..., M, n_freq) magnitude -> (..., length) waveform."""
    wav = istft(mag.to(torch.complex64), length, cfg)  # zero-phase start
    for _ in range(n_iter):
        spec = _stft_complex(wav, cfg)
        phase = spec / torch.clamp(spec.abs(), min=1e-8)
        wav = istft(mag * phase, length, cfg)
    return wav


def _max_length_for_frames(m: int, cfg: AudioConfig) -> int | None:
    """Largest sample count whose lws framing yields exactly m frames, or
    None when no positive length does (very short mels).

    num_frames is not monotone in length (its hop-unaligned branch adds 2
    where the aligned one adds 1), so each branch is inverted on its own:
    aligned lengths k*hop give k - 1 + fft//hop frames; unaligned lengths
    give (L + fft - 2*hop)//hop + 2."""
    fft, hop = cfg.fft_size, cfg.hop_size
    cands = []
    k = m + 1 - fft // hop
    if k >= 1:
        cands.append(k * hop)
    lb = (m + 1) * hop - fft - 1  # unaligned-branch upper bound
    for cand in (lb, lb - 1):     # step past a hop multiple if needed
        if cand >= 1 and cand % hop != 0:
            cands.append(cand)
            break
    good = [c for c in cands if num_frames(c, fft, hop) == m]
    return max(good) if good else None


def _padded_inversion_plan(m: int, cfg: AudioConfig) -> tuple[int, int, int]:
    """(target_frames, length, crop) for a mel too short to invert directly:
    pad the magnitude to target_frames so that the inferred length covers
    the promised m*hop samples, then crop back."""
    crop = max(1, m * cfg.hop_size)
    target_m = m + -(-cfg.fft_size // cfg.hop_size) + 1
    for _ in range(4 * target_m + 8):
        length = _max_length_for_frames(target_m, cfg)
        if length is not None and length >= crop:
            return target_m, length, crop
        target_m += 1
    raise ValueError(f"no invertible framing for m={m}, cfg={cfg}")


def default_inversion_length(m: int, cfg: AudioConfig) -> int:
    """The output length griffin_lim gives an m-frame magnitude when no
    explicit length is given (shared with the batch vocoder so that single
    and batched calls agree)."""
    length = _max_length_for_frames(m, cfg)
    if length is not None and length >= 1:
        return length
    return _padded_inversion_plan(m, cfg)[2]


@torch.inference_mode()
def griffin_lim(mag: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                n_iter: int = 32, length: int | None = None) -> np.ndarray:
    """Phase recovery from (..., M, n_freq) |STFT| on its device (role of
    librosa.griffinlim at reference processing.py:139).

    The default length is the largest sample count that frames to exactly
    M frames.  Very short inputs, where no positive length frames to M, are
    zero-padded to a viable frame count and cropped back to M*hop samples."""
    m = mag.shape[-2]
    crop = None
    if length is None:
        length = _max_length_for_frames(m, cfg)
        if length is None:
            target_m, length, crop = _padded_inversion_plan(m, cfg)
            mag = F.pad(mag, (0, 0, 0, target_m - m))
            m = target_m
    if num_frames(length, cfg.fft_size, cfg.hop_size) != m:
        raise ValueError(f"length {length} does not frame to {m} frames")
    wav = _griffin_lim(mag.to(torch.float32), int(length), int(n_iter), cfg)
    out = wav.cpu().numpy()
    return out[..., :crop] if crop is not None else out


def _peak_normalize(wav: np.ndarray) -> np.ndarray:
    peak = np.abs(wav).max() if wav.size else 0.0
    return (wav / peak * 0.95).astype(np.float32) if peak > 1e-8 else wav.astype(np.float32)


def mel_to_waveform(mel_norm: np.ndarray, cfg: AudioConfig = AudioConfig(),
                    n_iter: int = 32, device: str | torch.device = "cuda") -> np.ndarray:
    """[0, 1] (n_mels, T) mel -> waveform, peak-normalized to 0.95."""
    dev = resolve_device(device)
    mag = mel_to_stft_magnitude(torch.as_tensor(np.asarray(mel_norm, np.float32),
                                                device=dev), cfg)
    return _peak_normalize(griffin_lim(mag, cfg, n_iter))


def make_griffinlim_vocoder(cfg: AudioConfig = AudioConfig(), n_iter: int = 32,
                            device: str | torch.device = "cuda"):
    """Vocoder-protocol factory: (80, T) mel -> waveform (drop-in for
    convert.vocode.make_vocoder's return); ``.batch`` vocodes many mels as
    one padded batch on the device."""
    dev = resolve_device(device)

    def voc(mel: np.ndarray) -> np.ndarray:
        return mel_to_waveform(np.asarray(mel), cfg, n_iter, dev)

    def voc_batch(mels: list) -> list:
        if not mels:
            return []
        ts = [m.shape[1] for m in mels]
        # each output is cropped to the length its single call would give;
        # pad the stack until the batched inversion covers the longest of
        # them (zero-padded mel frames decode to near-silence)
        lens = [default_inversion_length(t, cfg) for t in ts]
        t_pad = max(ts)
        while default_inversion_length(t_pad, cfg) < max(lens):
            t_pad += 1
        stack = np.zeros((len(mels), mels[0].shape[0], t_pad), np.float32)
        for i, m in enumerate(mels):
            stack[i, :, :m.shape[1]] = np.asarray(m, np.float32)
        mag = mel_to_stft_magnitude(torch.from_numpy(stack).to(dev), cfg)
        wavs = griffin_lim(mag, cfg, n_iter)
        return [_peak_normalize(wavs[i, :lens[i]]) for i in range(len(ts))]

    voc.batch = voc_batch  # type: ignore[attr-defined]
    return voc
