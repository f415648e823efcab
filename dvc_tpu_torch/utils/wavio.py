"""Dependency-free audio IO: a copy of dvc_tpu/utils/wavio.py's read_wav,
read_audio and write_wav (PCM 8/16/24/32 and float32 RIFF via numpy +
struct; FLAC through the port's native decoder; m4a/AAC through ffmpeg)."""

from __future__ import annotations

import os
import struct

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a RIFF wav -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    return parse_wav(data, path)


def parse_wav(data: bytes, name: str = "<bytes>") -> tuple[np.ndarray, int]:
    """read_wav on an in-memory RIFF file (the HTTP body)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{name}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        wav = np.frombuffer(raw, dtype=np.float32).astype(np.float32)
    elif bits == 16:
        wav = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif bits == 32:
        wav = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        wav = vals.astype(np.float32) / float(1 << 23)
    elif bits == 8:
        wav = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{name}: unsupported bit depth {bits}")
    if channels > 1:
        wav = wav.reshape(-1, channels).mean(axis=1)
    return wav, sample_rate


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Extension-dispatched read: .flac via the native decoder
    (native/flac.py), .m4a/.aac/.mp4 via an external ffmpeg on PATH (the
    reference's situation: librosa falls back to audioread, which shells to
    ffmpeg, for VoxCeleb2 — encoder/preprocess.py:266-276), anything else
    via read_wav."""
    lower = path.lower()
    if lower.endswith(".flac"):
        from dvc_tpu_torch.native.flac import read_flac
        return read_flac(path)
    if lower.endswith((".m4a", ".aac", ".mp4")):
        return _external_decode(path)
    return read_wav(path)


def _external_decode(path: str) -> tuple[np.ndarray, int]:
    """Decode a compressed container through ffmpeg into a temporary PCM16
    wav (a file, not stdout: streamed RIFF headers carry sizes the strict
    parser rejects)."""
    import shutil
    import subprocess
    import tempfile

    exe = shutil.which("ffmpeg")
    if exe is None:
        raise NotImplementedError(
            f"{path}: m4a/AAC decode needs ffmpeg on PATH (the reference's "
            "audioread backend for VoxCeleb2 shells out to it too); install "
            "ffmpeg or convert the audio to wav/flac first")
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run(
            [exe, "-y", "-v", "error", "-i", path,
             "-f", "wav", "-acodec", "pcm_s16le", tmp_path],
            capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"ffmpeg failed on {path}: {proc.stderr.decode(errors='replace')[:500]}")
        return read_wav(tmp_path)
    finally:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass


def wav_bytes(wav: np.ndarray, sample_rate: int = 16_000) -> bytes:
    """Float waveform -> PCM16 RIFF bytes, peak-rescaled to full scale — the
    reference's save_wav convention (preprocessing/utils.py:19-21:
    wav *= 32767 / max(0.01, |wav|.max()))."""
    wav = np.asarray(wav, np.float64)
    peak = float(np.max(np.abs(wav))) if wav.size else 0.0
    scaled = (wav * (32767.0 / max(0.01, peak))) \
        .clip(-32768, 32767).astype(np.int16)
    body = scaled.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(body))
    return hdr + body


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16_000) -> None:
    """Write float waveform as peak-normalized PCM16 (see wav_bytes)."""
    with open(path, "wb") as f:
        f.write(wav_bytes(wav, sample_rate))
