"""The mel front end and the wav container, in plain PyTorch and NumPy.

Frozen copies of the reference recipe (preprocessing/utils.py:68-143 of
the published system, librosa's Slaney filterbank, lws framing with a
periodic sqrt-hann window) and of the windowed-sinc polyphase resampler
that stands in for librosa.resample; and the PCM16 wav encoding with the
reference's peak rescaling (preprocessing/utils.py:19-21).
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch
import torch.nn.functional as F


def sinc_kernel(up: int, down: int, num_zeros: int = 16, rolloff: float = 0.945) -> np.ndarray:
    cutoff = rolloff * 0.5 / max(up, down)
    half = int(np.ceil(num_zeros / (2 * cutoff)))
    n = np.arange(-half, half + 1, dtype=np.float64)
    win = np.hanning(len(n) + 2)[1:-1]
    return (2 * cutoff * np.sinc(2 * cutoff * n) * win * up).astype(np.float32)


def resample(wav: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """(T,) -> (ceil(T * up / down),): zero-stuff by up, filter, keep every
    down-th sample."""
    if orig_sr == target_sr:
        return wav.float()
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    kernel = torch.from_numpy(sinc_kernel(up, down)).to(wav.device)
    pad = kernel.numel() // 2
    t = wav.shape[-1]
    out_len = -(-t * up // down)
    stuffed_len = (t - 1) * up + 1
    pad_r = max(pad, (out_len - 1) * down + pad + 1 - stuffed_len)
    stuffed = wav.new_zeros(1, 1, pad + stuffed_len + pad_r, dtype=torch.float32)
    stuffed[..., pad:pad + stuffed_len:up] = wav.float()
    return F.conv1d(stuffed, kernel.view(1, 1, -1), stride=down).reshape(-1)[:out_len]


def num_frames(length: int, fsize: int, fshift: int) -> int:
    pad = fsize - fshift
    if length % fshift == 0:
        return (length + pad * 2 - fsize) // fshift + 1
    return (length + pad * 2 - fsize) // fshift + 2


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    m * (200.0 / 3.0))


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return w.astype(np.float32)


def melspectrogram(wav: torch.Tensor, audio: dict) -> torch.Tensor:
    """(T,) 16 kHz float32 -> (n_mels, frames) in [0, 1]."""
    fsize, fshift = audio["fft_size"], audio["hop_size"]
    t = wav.shape[-1]
    m = num_frames(t, fsize, fshift)
    left = fsize - fshift
    right = left + (m - 1) * fshift + fsize - (t + 2 * left)
    frames = F.pad(wav.float(), (left, right)).unfold(-1, fsize, fshift)
    n = np.arange(fsize, dtype=np.float64)
    win = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / fsize)).astype(np.float32)
    mag = torch.fft.rfft(frames * torch.from_numpy(win).to(wav.device), n=fsize).abs()
    basis = torch.from_numpy(mel_basis(audio["sample_rate"], fsize, audio["num_mels"],
                                       audio["fmin"], audio["fmax"])).to(wav.device)
    mel = mag @ basis.T
    floor = math.exp(audio["min_level_db"] / 20.0 * math.log(10.0))
    db = 20.0 * torch.log10(torch.clamp(mel, min=floor)) - audio["ref_level_db"]
    return torch.clamp((db - audio["min_level_db"]) / -audio["min_level_db"], 0.0, 1.0).T


def front_end(wav: np.ndarray, sr: int, audio: dict, device) -> torch.Tensor:
    """A request's wav at ``sr`` -> its mel at the model's rate: resample,
    then the mel of the sample count zero-padded to a power of two, cropped
    to the true frame count (the padding extends the framing's own zero
    padding, so the kept frames are those of the unpadded signal)."""
    x = resample(torch.from_numpy(np.asarray(wav, np.float32)).to(device), sr,
                 audio["sample_rate"])
    n = x.shape[-1]
    b = 1
    while b < max(n, audio["hop_size"]):
        b <<= 1
    mel = melspectrogram(F.pad(x, (0, b - n)), audio)
    return mel[:, :num_frames(n, audio["fft_size"], audio["hop_size"])]


def chunk(mel: torch.Tensor, frames: int) -> torch.Tensor:
    """(n_mels, T) -> (T // frames + 1, n_mels, frames), the last chunk
    zero-padded (an exact multiple keeps an all-zero chunk, as the
    reference's chunking_mel does)."""
    n_mels, t = mel.shape
    n = t // frames + 1
    return F.pad(mel, (0, n * frames - t)).reshape(n_mels, n, frames).permute(1, 0, 2)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """PCM16 RIFF bytes, peak-rescaled to full scale."""
    wav = np.asarray(wav, np.float64)
    peak = float(np.max(np.abs(wav))) if wav.size else 0.0
    body = (wav * (32767.0 / max(0.01, peak))).clip(-32768, 32767).astype(np.int16).tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", len(body)) + body)


def pcm16_of(body: bytes) -> tuple[np.ndarray, int]:
    """(int16 samples, sample rate) of a mono PCM16 RIFF file."""
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE body")
    pos, rate, data = 12, None, None
    while pos + 8 <= len(body):
        cid, size = body[pos:pos + 4], struct.unpack("<I", body[pos + 4:pos + 8])[0]
        if cid == b"fmt ":
            fmt, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[pos + 8:pos + 24])
            if (fmt, channels, bits) != (1, 1, 16):
                raise ValueError(f"not mono PCM16: format {fmt}, {channels} ch, {bits} bits")
        elif cid == b"data":
            data = np.frombuffer(body[pos + 8:pos + 8 + size], np.int16)
        pos += 8 + size + (size & 1)
    if rate is None or data is None:
        raise ValueError("missing fmt or data chunk")
    return data, rate
