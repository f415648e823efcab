"""Speech-like inputs made from the seed: request wavs, speakers' mels and
training corpora.

A voiced utterance is a harmonic source on a moving f0 (a speaker's base
pitch, a slow glide and a vibrato), shaped by three formants that move
with each syllable, gated by a syllable-rate envelope with short pauses,
over a noise floor 40 dB down.  Everything is made on the device in a few
batched calls.  Training corpora are features made directly (mels in
[0, 1] with formant bands and a syllable envelope; WORLD-like normalized
mel-cepstra as smooth trajectories): the step's time does not depend on
their values, and making them from audio would only lengthen set-up.
"""

from __future__ import annotations

import math
import os
from statistics import NormalDist

import numpy as np
import torch

from port_bench.common import derive
from port_bench.reference import audio as ref_audio


def stratified_lengths(n: int, median_s: float, sigma: float, lo: float, hi: float) -> list[float]:
    """The n quantiles (i + 0.5) / n of a log-normal length, clipped: one
    fixed set of sizes, which every seed serves in its own order."""
    nd = NormalDist()
    return [min(hi, max(lo, median_s * math.exp(sigma * nd.inv_cdf((i + 0.5) / n))))
            for i in range(n)]


def speech(lengths: list[int], sr: int, seed: int, device, f0_base: float | None = None
           ) -> list[torch.Tensor]:
    """Speech-like float32 waveforms in [-0.5, 0.5], one per length (in
    samples), on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    outs = []
    for n in lengths:
        r = torch.rand(12, generator=gen, device=device)
        t = torch.arange(n, device=device, dtype=torch.float32) / sr
        f0b = f0_base if f0_base is not None else 90.0 + 160.0 * r[0].item()
        f0 = f0b * (1.0 + 0.15 * torch.sin(2 * math.pi * (0.3 + 0.4 * r[1]) * t)
                    + 0.02 * torch.sin(2 * math.pi * 5.5 * t))
        phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
        syl = 3.0 + 2.0 * r[2]
        env = torch.clamp(torch.sin(math.pi * syl * t + r[3] * 6.28), min=0.0) ** 0.6
        k = torch.arange(1, 41, device=device, dtype=torch.float32)
        fk = f0[None, :] * k[:, None]                                    # (K, n)
        wob = torch.sin(2 * math.pi * syl * 0.5 * t)[None, :]
        amp = torch.zeros_like(fk)
        for j, (fc, bw) in enumerate(((500.0, 120.0), (1500.0, 200.0), (2500.0, 300.0))):
            centre = fc * (1.0 + 0.25 * (r[4 + j] - 0.5)) * (1.0 + 0.15 * wob)
            amp += torch.exp(-((fk - centre) / bw) ** 2)
        amp = amp * (fk < 0.45 * sr) / k[:, None]
        x = (amp * torch.sin(k[:, None] * phase[None, :] + 6.28 * r[7])).sum(0) * env
        x = x + 0.01 * torch.randn(n, generator=gen, device=device)
        outs.append(0.5 * x / x.abs().max().clamp(min=1e-6))
    return outs


def pcm16_wav(x: torch.Tensor, sr: int) -> bytes:
    """A request body: 16-bit PCM RIFF at ``sr``, as recorded (no peak
    rescaling)."""
    import struct
    body = (x.clamp(-1, 1) * 32767.0).round().to(torch.int16).cpu().numpy().tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", len(body)) + body)


def speaker_mels(root: str, audio: dict, speakers: int, files: int, seconds: float,
                 seed: int, device) -> list[str]:
    """Target speakers' mel files, ``root/spkNN/uttMM.npy`` (n_mels, T),
    made with the reference mel front end from speech-like audio."""
    names = []
    sr = audio["sample_rate"]
    for s in range(speakers):
        name = f"spk{s:02d}"
        os.makedirs(os.path.join(root, name), exist_ok=True)
        f0 = 90.0 + 160.0 * s / max(speakers - 1, 1)
        wavs = speech([int(seconds * sr)] * files, sr, derive(seed, s), device, f0)
        for u, w in enumerate(wavs):
            mel = ref_audio.melspectrogram(w, audio).cpu().numpy().astype(np.float32)
            np.save(os.path.join(root, name, f"utt{u:02d}.npy"), mel)
        names.append(name)
    return names


def training_corpus(root: str, kind: str, dims: int, frames_per_s: float, speakers: int,
                    files: int, lengths: dict, seed: int, device) -> int:
    """A paired-training corpus, ``root/pNNN/uttMM.npy`` ((dims, T) mels in
    [0, 1]) or ``.npz`` (``normalized_mc`` (T, dims)); lengths log-normal
    per the traffic's parameters.  Returns the bytes written."""
    rng = np.random.default_rng(seed)
    secs = np.exp(np.log(lengths["median_s"]) + lengths["sigma"] * rng.standard_normal(
        (speakers, files)))
    secs = np.clip(secs, lengths["min_s"], lengths["max_s"])
    gen = torch.Generator(device=device).manual_seed(seed)
    written = 0
    band = torch.arange(dims, device=device, dtype=torch.float32)
    for s in range(speakers):
        d = os.path.join(root, f"p{s:03d}")
        os.makedirs(d, exist_ok=True)
        ts = [int(x * frames_per_s) for x in secs[s]]
        tmax = max(ts)
        t = torch.arange(tmax, device=device, dtype=torch.float32) / frames_per_s
        r = torch.rand(files, 8, generator=gen, device=device)
        if kind == "mel":
            env = torch.clamp(torch.sin(math.pi * (3 + 2 * r[:, :1]) * t + 6.28 * r[:, 1:2]),
                              min=0.0) ** 0.6                                   # (F, T)
            feat = 0.15 + 0.1 * torch.rand(files, dims, tmax, generator=gen, device=device)
            for j in range(3):
                centre = dims * (0.15 + 0.25 * j + 0.1 * r[:, 2 + j:3 + j])     # (F, 1)
                move = centre[:, None, :] * (1 + 0.1 * torch.sin(6.0 * t))[None, None, :]
                feat += 0.5 * torch.exp(-((band[None, :, None] - move) / 3.0) ** 2) \
                    * env[:, None, :]
            feat = feat.clamp(0.0, 1.0)
        else:
            w = 0.5 + 3.0 * torch.rand(files, dims, 3, generator=gen, device=device)
            ph = 6.28 * torch.rand(files, dims, 3, generator=gen, device=device)
            feat = torch.sin(w[..., None] * t + ph[..., None]).sum(2) / math.sqrt(1.5)
            feat += 0.3 * torch.randn(files, dims, tmax, generator=gen, device=device)
        feat = feat.cpu().numpy().astype(np.float32)
        for u, n in enumerate(ts):
            if kind == "mel":
                fp = os.path.join(d, f"utt{u:02d}.npy")
                np.save(fp, np.ascontiguousarray(feat[u, :, :n]))
            else:
                fp = os.path.join(d, f"utt{u:02d}.npz")
                np.savez(fp, normalized_mc=np.ascontiguousarray(feat[u, :, :n].T))
            written += os.path.getsize(fp)
    return written
