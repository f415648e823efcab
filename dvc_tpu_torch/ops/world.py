"""WORLD analysis for MCD, the native route (port of the analysis half of
dvc_tpu/ops/world.py).

The reference calls pyworld and pysptk (preprocessing/WORLD_processing.py:
29-39): Harvest F0, CheapTrick spectral envelope, D4C aperiodicity, and the
envelope's mel-cepstrum through sp2mc.  As dvc_tpu's native route does it
(dvc_tpu/ops/world.py:507-564), Harvest and D4C run on the host in the C++
engine (native/dvc_world.cpp) and CheapTrick and the mel-cepstrum run on
the device, here in torch on ``device``.

``freqt``, SPTK's frequency warping, is a nested recursion that dvc_tpu
writes as a double ``lax.scan``.  For a fixed order and alpha it is linear
in the input cepstrum, so the port runs dvc_tpu's recursion once, in
float64 on the host, on the unit vectors, which gives the
``(n_in, order + 1)`` matrix of the map, and applies it to every frame as
one matrix product (in float64, so no TF32 mode can round it).

dvc_tpu's all-JAX fallback chain (NCCF F0, correlation aperiodicity) and
its batched device analysis (``world_decompose_batch``) are not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.utils.device import resolve_device

DEFAULT_F0 = 500.0
Q1 = -0.15


@functools.lru_cache(maxsize=8)
def mcepalpha(fs: int, start: float = 0.0, stop: float = 1.0,
              step: float = 0.001, num_points: int = 1000) -> float:
    """Best all-pass constant approximating the mel scale at fs: pysptk's
    mcepalpha math, as dvc_tpu computes it (16 kHz -> 0.41)."""
    alphas = np.arange(start, stop, step)
    fstep = (fs / 2.0) / num_points
    mel = 1000.0 / np.log(2.0) * np.log(1.0 + fstep * np.arange(num_points) / 1000.0)
    mel = mel / mel[-1]
    om = (np.pi / num_points) * np.arange(num_points)
    best, best_err = 0.0, np.inf
    for a in alphas:
        num = (1 - a * a) * np.sin(om)
        den = (1 + a * a) * np.cos(om) - 2 * a
        warp = np.arctan2(num, den)
        warp = np.where(warp < 0, warp + np.pi, warp)
        warp = warp / warp[-1]
        err = np.sqrt(np.mean((mel - warp) ** 2))
        if err < best_err:
            best, best_err = float(a), err
    return best


@functools.lru_cache(maxsize=8)
def freqt_matrix(n_in: int, order: int, alpha: float) -> np.ndarray:
    """(n_in, order + 1) float64 matrix A with freqt(c) = c @ A: dvc_tpu's
    recursion (dvc_tpu/ops/world.py:83-117) run on the n_in unit vectors at
    once.  Input coefficients enter in reverse order; each one updates the
    whole output vector."""
    eye = np.eye(n_in)
    h = np.zeros((n_in, order + 1))
    for i in range(n_in - 1, -1, -1):
        prev = h
        h = np.empty_like(prev)
        h[:, 0] = eye[:, i] + alpha * prev[:, 0]
        if order >= 1:
            h[:, 1] = (1 - alpha ** 2) * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order + 1):
            h[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - h[:, m - 1])
    return h


def freqt(c: torch.Tensor, order: int, alpha: float) -> torch.Tensor:
    """SPTK frequency transform: cepstrum (..., n_in) -> warped cepstrum
    (..., order + 1), one float64 matrix product on c's device."""
    a = torch.from_numpy(freqt_matrix(c.shape[-1], order, float(alpha))).to(c.device)
    return (c.to(torch.float64) @ a).to(c.dtype)


def sp2mc(sp: torch.Tensor, order: int, alpha: float) -> torch.Tensor:
    """Power spectrum (..., n_fft//2+1) -> mel-cepstrum (..., order+1)
    (pysptk sp2mc: real cepstrum of the log-spectrum, halved c0, freqt)."""
    n = sp.shape[-1]
    c = torch.fft.irfft(torch.log(torch.clamp(sp, min=1e-30)), dim=-1)[..., :n].clone()
    c[..., 0] *= 0.5
    return freqt(c, order, alpha)


def cheaptrick_fft_size(fs: int, f0_floor: float = 71.0) -> int:
    """WORLD's CheapTrick FFT-size rule (the spectral grid that CheapTrick,
    D4C and the mel-cepstrum agree on)."""
    return int(2 ** np.ceil(np.log2(3.0 * fs / f0_floor + 1)))


def spectral_envelope(wav: torch.Tensor, f0: torch.Tensor, fs: int = 16_000,
                      frame_period: float = 5.0, fft_size: int | None = None
                      ) -> torch.Tensor:
    """CheapTrick (Morise 2015): (T,), (N,) -> power envelope
    (N, fft_size//2+1), on wav's device, float32: (1) an f0-adaptive
    Hanning window of 3 T0, power-normalized; (2) the power spectrum
    smoothed by a rectangle 2/3 f0 wide; (3) liftering with
    sin(pi f0 q)/(pi f0 q) and the q1 compensation lifter.

    The arithmetic follows dvc_tpu/ops/world.py:219-291 operation by
    operation.  Python constants meet float32 tensors as float32 values,
    as jax's weak types make them, and a division by a constant stays a
    division (torch's ``scalar / tensor`` and CUDA's ``tensor / scalar``
    multiply by a reciprocal, which rounds differently)."""
    dev = wav.device
    if fft_size is None:
        fft_size = cheaptrick_fft_size(fs)

    def k(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    n_freq = fft_size // 2 + 1
    hop = int(fs * frame_period / 1000.0)
    n_frames = f0.shape[0]
    f0 = f0.to(dev, torch.float32)
    f0_safe = torch.where(f0 > 0, f0, k(DEFAULT_F0))
    half_win = torch.clamp((k(1.5 * fs) / f0_safe).to(torch.int32), max=fft_size // 2 - 1)

    # frame n reads pad[n*hop : n*hop + fft_size], centred on sample n*hop
    right = max(fft_size, (n_frames - 1) * hop + fft_size // 2 - wav.shape[0])
    pad = F.pad(wav.to(torch.float32), (fft_size // 2, right))
    segs = pad.unfold(0, fft_size, hop)[:n_frames]

    t = (torch.arange(fft_size, device=dev, dtype=torch.float32) - fft_size // 2)[None, :]
    hw = half_win.to(torch.float32)[:, None]
    window = 0.5 + 0.5 * torch.cos(np.pi * t / hw)
    window = torch.where(t.abs() <= hw, window, k(0.0))
    wnorm = torch.sqrt(torch.sum(window ** 2, dim=-1, keepdim=True))
    window = window / torch.clamp(wnorm, min=1e-12)
    spec = torch.fft.rfft(segs * window, n=fft_size, dim=-1).abs() ** 2

    # (2) frequency smoothing: cumulative sum, linearly interpolated bounds
    width_bins = torch.clamp((2.0 / 3.0) * f0_safe / k(fs / fft_size), min=1.0)
    csum = torch.cumsum(F.pad(spec, (1, 0)).to(torch.float64), dim=-1)
    kk = torch.arange(n_freq, device=dev, dtype=torch.float32)[None, :]
    lo = torch.clamp(kk - width_bins[:, None] / k(2.0), 0, n_freq - 1)
    hi = torch.clamp(kk + width_bins[:, None] / k(2.0), 0, n_freq - 1)

    def interp_csum(pos):
        i0 = torch.floor(pos).to(torch.int64)
        frac = (pos - i0.to(torch.float32)).to(torch.float64)
        c0 = torch.gather(csum, -1, i0)
        c1 = torch.gather(csum, -1, torch.clamp(i0 + 1, max=n_freq))
        return c0 * (1 - frac) + c1 * frac

    smoothed = (interp_csum(hi) - interp_csum(lo)) / torch.clamp(hi - lo, min=1e-6)
    smoothed = torch.clamp(smoothed, min=1e-30).to(torch.float32)

    # (3) liftering in the quefrency domain
    logspec = torch.log(smoothed)
    full = torch.cat([logspec, logspec[..., 1:-1].flip(-1)], dim=-1)
    ceps = torch.fft.rfft(full, dim=-1).real / k(fft_size) * 2
    q = torch.arange(ceps.shape[-1], device=dev, dtype=torch.float32)[None, :] / k(fs)
    f0q = f0_safe[:, None] * q
    sinc = torch.where(f0q == 0, k(1.0),
                       torch.sin(np.pi * f0q) / torch.clamp(np.pi * f0q, min=1e-12))
    comp = (1.0 - 2.0 * Q1) + 2.0 * Q1 * torch.cos(2 * np.pi * f0q)
    ceps = ceps * sinc * comp
    rec = torch.fft.irfft(ceps, n=fft_size, dim=-1) * fft_size / 2
    return torch.exp(rec[..., :n_freq])


def envelope_mcep(wav: torch.Tensor, f0: torch.Tensor, fs: int, frame_period: float,
                  num_mcep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CheapTrick and the mel-cepstrum for a given F0 contour, on the
    device (dvc_tpu's _envelope_mcep_chain)."""
    sp = spectral_envelope(wav, f0, fs, frame_period)
    return sp, sp2mc(sp, order=num_mcep - 1, alpha=mcepalpha(fs))


def world_decompose(wav: np.ndarray, fs: int, frame_period: float = 5.0,
                    num_mcep: int = 36, pad_to: int = 8000,
                    device: str | torch.device = "cuda"):
    """Reference world_decompose (WORLD_processing.py:29-39), dvc_tpu's
    native route: returns numpy (f0, timeaxis, sp, ap, mc) of
    len(wav)//hop + 1 frames.  Harvest F0 and D4C aperiodicity in the C++
    engine on the host; CheapTrick and sp2mc on ``device`` over the wav
    zero-padded to a multiple of ``pad_to`` samples (dvc_tpu pads to reuse
    compiled shapes; the port pads alike, so that it reads the same
    samples), cropped back."""
    from dvc_tpu_torch.native import world as native_world

    dev = resolve_device(device)
    hop = int(fs * frame_period / 1000.0)
    n_true = len(wav) // hop + 1
    wav = np.asarray(wav, np.float32)
    f0, timeaxis = native_world.harvest(wav, fs, frame_period)
    # n_true and harvest's own frame count agree only when
    # fs * frame_period / 1000 is an integer: crop or pad f0 to n_true
    if len(f0) < n_true:
        f0 = np.pad(f0, (0, n_true - len(f0)))
        timeaxis = np.arange(n_true) * frame_period / 1000.0
    f0 = f0[:n_true]
    padded, f0_padded = wav, f0
    if pad_to:
        bucket = int(np.ceil((len(wav) + 1) / pad_to)) * pad_to
        padded = np.pad(wav, (0, bucket - len(wav)))
        f0_padded = np.pad(f0, (0, bucket // hop + 1 - len(f0)))
    with torch.inference_mode():
        sp, mc = envelope_mcep(torch.from_numpy(padded).to(dev),
                               torch.from_numpy(f0_padded.astype(np.float32)).to(dev),
                               fs, frame_period, num_mcep)
        sp, mc = sp[:n_true].cpu().numpy(), mc[:n_true].cpu().numpy()
    ap = native_world.d4c(wav, f0, fs, frame_period, fft_size=2 * (sp.shape[-1] - 1))
    return (np.asarray(f0, np.float32), np.asarray(timeaxis[:n_true], np.float32),
            sp, np.asarray(ap, np.float32)[:n_true], mc)


def world_encode_data(wav: np.ndarray, fs: int, frame_period: float = 5.0,
                      num_mcep: int = 36, device: str | torch.device = "cuda"):
    """Reference world_encode_data (WORLD_processing.py:61-77)."""
    return world_decompose(wav, fs, frame_period, num_mcep, device=device)
