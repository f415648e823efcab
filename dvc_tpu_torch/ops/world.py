"""WORLD analysis and synthesis (port of dvc_tpu/ops/world.py).

The reference calls pyworld and pysptk (preprocessing/WORLD_processing.py:
29-39, 50-59, 99-106): Harvest F0, CheapTrick spectral envelope, D4C
aperiodicity, the envelope's mel-cepstrum through sp2mc and back through
mc2sp, and WORLD synthesis.  As in dvc_tpu there are two routes:

  * native, one utterance at a time: Harvest and D4C run on the host in
    the C++ engine (native/dvc_world.cpp), CheapTrick and the mel-cepstrum
    on ``device`` (``world_decompose``); the engine's pulse-by-pulse
    synthesizer (``world_speech_synthesis``);
  * batched on the device: Harvest (ops/harvest.py), CheapTrick, the
    mel-cepstrum and D4C (ops/d4c.py) over length buckets of utterances
    (``world_decompose_batch``), and the frame-rate overlap-add synthesis
    (``synthesize_batch``).

``use_native=False`` takes dvc_tpu's all-device chain instead: the NCCF F0
tracker (``estimate_f0``), CheapTrick, the correlation aperiodicity
(``aperiodicity``) and the mel-cepstrum in ``world_decompose``, the
device ``synthesize`` in ``world_speech_synthesis``.  ``True``, the
default, takes the native engine, which raises if it fails to build:
nothing falls back.

``freqt``, SPTK's frequency warping, is a nested recursion that dvc_tpu
writes as a double ``lax.scan``.  For a fixed order and alpha it is linear
in the input cepstrum, so the port runs dvc_tpu's recursion once, in
float64 on the host, on the unit vectors, which gives the
``(n_in, order + 1)`` matrix of the map, and applies it to every frame as
one matrix product (in float64, so no TF32 mode can round it).

The device synthesis sums its pulse phase in the order XLA's cumsum uses
(``xla_cumsum``), so that its pulses fall on the samples dvc_tpu's do, and
draws its noise from ``synthesis_noise``, one CPU ``torch.Generator`` an
utterance, so the card and the CPU synthesize from the same draws.
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


def mc2sp(mc: torch.Tensor, alpha: float, fftlen: int) -> torch.Tensor:
    """Mel-cepstrum (..., order+1) -> power spectrum (..., fftlen//2+1)
    (pysptk mc2sp: unwarp by freqt with -alpha, doubled c0, the even
    extension's Fourier transform, exp).  dvc_tpu runs freqt here as a
    float32 recursion to order fftlen/2; the port's is the float64 matrix."""
    n = fftlen // 2 + 1
    c = freqt(mc, n - 1, -alpha).clone()
    c[..., 0] *= 2.0
    sym = torch.cat([c, c[..., 1:-1].flip(-1)], dim=-1)
    return torch.exp(torch.fft.rfft(sym, dim=-1).real)


# --- F0 estimation (the all-device chain) -------------------------------------

def estimate_f0(wav: torch.Tensor, fs: int = 16_000, frame_period: float = 5.0,
                f0_floor: float = 71.0, f0_ceil: float = 800.0,
                threshold: float = 0.30) -> tuple[torch.Tensor, torch.Tensor]:
    """(T,) waveform -> (f0 (N,), timeaxis (N,)) at ``frame_period`` ms on
    wav's device (dvc_tpu/ops/world.py:146-210): NCCF peak picking in the
    lag band [fs/f0_ceil, fs/f0_floor] with parabolic refinement, voicing
    by the correlation ``threshold`` and an energy gate, 3-tap median
    smoothing.  pyworld.harvest's contract: f0 == 0 where unvoiced."""
    wav = torch.as_tensor(wav).to(torch.float32)
    hop = int(fs * frame_period / 1000.0)
    lag_min = int(np.floor(fs / f0_ceil))
    lag_max = int(np.ceil(fs / f0_floor))
    win = 2 * lag_max  # two periods of the lowest pitch
    n_frames = int(wav.shape[-1] // hop) + 1
    frames = F.pad(wav, (win // 2, win + lag_max)).unfold(-1, win + lag_max, hop)[:n_frames]
    base = frames[:, :win]
    base = base - base.mean(-1, keepdim=True)
    e0 = (base * base).sum(-1)
    # corr(k) = sum_t base[t] * frame[t + k] for every lag k of the band
    shifted = frames.unfold(-1, win, 1)[:, lag_min:lag_max + 1]
    shifted = shifted - shifted.mean(-1, keepdim=True)
    num = torch.einsum("nw,nlw->nl", base, shifted)
    nccf = num / torch.sqrt(e0[:, None] * (shifted * shifted).sum(-1) + 1e-12)
    n_lags = nccf.shape[-1]
    best = nccf.argmax(-1)
    best_corr = nccf.gather(-1, best[:, None])[:, 0]
    ym1 = nccf.gather(-1, (best - 1).clamp(0, n_lags - 1)[:, None])[:, 0]
    yp1 = nccf.gather(-1, (best + 1).clamp(0, n_lags - 1)[:, None])[:, 0]
    denom = ym1 - 2 * best_corr + yp1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (ym1 - yp1) / denom, 0.0).clamp(-1.0, 1.0)
    f0 = fs / (lag_min + best + delta)
    energy_db = 10.0 * torch.log10(e0 / win + 1e-12)
    voiced = (best_corr > threshold) & (energy_db > -55.0) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    f0 = torch.where(voiced, f0, 0.0)
    f0_pad = F.pad(f0[None, None], (1, 1), mode="replicate")[0, 0]
    f0 = torch.stack([f0_pad[:-2], f0_pad[1:-1], f0_pad[2:]]).median(0).values
    timeaxis = torch.arange(n_frames, device=wav.device, dtype=torch.float32) * hop / fs
    return f0, timeaxis


def cheaptrick_fft_size(fs: int, f0_floor: float = 71.0) -> int:
    """WORLD's CheapTrick FFT-size rule (the spectral grid that CheapTrick,
    D4C and the mel-cepstrum agree on)."""
    return int(2 ** np.ceil(np.log2(3.0 * fs / f0_floor + 1)))


def spectral_envelope(wav: torch.Tensor, f0: torch.Tensor, fs: int = 16_000,
                      frame_period: float = 5.0, fft_size: int | None = None
                      ) -> torch.Tensor:
    """CheapTrick (Morise 2015): (..., T), (..., N) -> power envelope
    (..., N, fft_size//2+1), on wav's device, float32: (1) an f0-adaptive
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
    n_frames = f0.shape[-1]
    f0 = f0.to(dev, torch.float32)
    f0_safe = torch.where(f0 > 0, f0, k(DEFAULT_F0))
    half_win = torch.clamp((k(1.5 * fs) / f0_safe).to(torch.int32), max=fft_size // 2 - 1)

    # frame n reads pad[n*hop : n*hop + fft_size], centred on sample n*hop
    right = max(fft_size, (n_frames - 1) * hop + fft_size // 2 - wav.shape[-1])
    pad = F.pad(wav.to(torch.float32), (fft_size // 2, right))
    segs = pad.unfold(-1, fft_size, hop)[..., :n_frames, :]

    t = (torch.arange(fft_size, device=dev, dtype=torch.float32) - fft_size // 2)[None, :]
    hw = half_win.to(torch.float32)[..., None]
    window = 0.5 + 0.5 * torch.cos(np.pi * t / hw)
    window = torch.where(t.abs() <= hw, window, k(0.0))
    wnorm = torch.sqrt(torch.sum(window ** 2, dim=-1, keepdim=True))
    window = window / torch.clamp(wnorm, min=1e-12)
    spec = torch.fft.rfft(segs * window, n=fft_size, dim=-1).abs() ** 2

    # (2) frequency smoothing: cumulative sum, linearly interpolated bounds
    width_bins = torch.clamp((2.0 / 3.0) * f0_safe / k(fs / fft_size), min=1.0)
    csum = torch.cumsum(F.pad(spec, (1, 0)).to(torch.float64), dim=-1)
    kk = torch.arange(n_freq, device=dev, dtype=torch.float32)[None, :]
    lo = torch.clamp(kk - width_bins[..., None] / k(2.0), 0, n_freq - 1)
    hi = torch.clamp(kk + width_bins[..., None] / k(2.0), 0, n_freq - 1)

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
    f0q = f0_safe[..., None] * q
    sinc = torch.where(f0q == 0, k(1.0),
                       torch.sin(np.pi * f0q) / torch.clamp(np.pi * f0q, min=1e-12))
    comp = (1.0 - 2.0 * Q1) + 2.0 * Q1 * torch.cos(2 * np.pi * f0q)
    ceps = ceps * sinc * comp
    rec = torch.fft.irfft(ceps, n=fft_size, dim=-1) * fft_size / 2
    return torch.exp(rec[..., :n_freq])


def aperiodicity(wav: torch.Tensor, f0: torch.Tensor, fs: int = 16_000,
                 frame_period: float = 5.0, fft_size: int | None = None) -> torch.Tensor:
    """The all-device chain's band aperiodicity in D4C's role
    (dvc_tpu/ops/world.py:293-330): per frame 1 - |r(T0)|, the normalized
    autocorrelation at the pitch lag, clipped, shaped by a mild upward
    tilt with frequency onto the (N, fft_size//2+1) grid; unvoiced frames
    get 1 - 1e-12 (1 in float32)."""
    wav = torch.as_tensor(wav).to(torch.float32)
    f0 = torch.as_tensor(f0).to(wav.device, torch.float32)
    if fft_size is None:
        fft_size = cheaptrick_fft_size(fs)
    n_freq = fft_size // 2 + 1
    hop = int(fs * frame_period / 1000.0)
    n, win = f0.shape[0], 1024
    right = max(win * 2, (n - 1) * hop + 2 * win - win // 2 - wav.shape[-1])
    segs = F.pad(wav, (win // 2, right)).unfold(-1, win * 2, hop)[:n]
    base = segs[:, :win] - segs[:, :win].mean(-1, keepdim=True)
    f0_safe = torch.where(f0 > 0, f0, DEFAULT_F0)
    lag = (fs / f0_safe).to(torch.int32).clamp(1, win - 1).long()
    shifted = segs.gather(-1, lag[:, None] + torch.arange(win, device=wav.device)[None, :])
    shifted = shifted - shifted.mean(-1, keepdim=True)
    r = (base * shifted).sum(-1) / torch.sqrt((base ** 2).sum(-1) * (shifted ** 2).sum(-1)
                                             + 1e-12)
    top = float(np.float32(1.0 - 1e-12))
    ap_base = (1.0 - r.abs()).clamp(0.001, 1.0)
    ap_base = torch.where(f0 > 0, ap_base, top)
    tilt = 0.3 + 0.7 * torch.linspace(0.0, 1.0, n_freq, device=wav.device)[None, :]
    ap = ap_base[:, None].sqrt() * tilt + ap_base[:, None] * (1.0 - tilt)
    return torch.where(f0[:, None] > 0, ap, top).clamp(0.001, top)


def _analysis_chain(wav: torch.Tensor, fs: int, frame_period: float, num_mcep: int):
    """The all-device WORLD analysis: NCCF F0, CheapTrick, the correlation
    aperiodicity, the mel-cepstrum (dvc_tpu's _analysis_chain)."""
    f0, timeaxis = estimate_f0(wav, fs, frame_period)
    sp = spectral_envelope(wav, f0, fs, frame_period)
    ap = aperiodicity(wav, f0, fs, frame_period, fft_size=2 * (sp.shape[-1] - 1))
    return f0, timeaxis, sp, ap, sp2mc(sp, order=num_mcep - 1, alpha=mcepalpha(fs))


def envelope_mcep(wav: torch.Tensor, f0: torch.Tensor, fs: int, frame_period: float,
                  num_mcep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CheapTrick and the mel-cepstrum for a given F0 contour, on the
    device (dvc_tpu's _envelope_mcep_chain)."""
    sp = spectral_envelope(wav, f0, fs, frame_period)
    return sp, sp2mc(sp, order=num_mcep - 1, alpha=mcepalpha(fs))


def world_decompose(wav: np.ndarray, fs: int, frame_period: float = 5.0,
                    num_mcep: int = 36, pad_to: int = 8000,
                    use_native: bool = True, device: str | torch.device = "cuda"):
    """Reference world_decompose (WORLD_processing.py:29-39): returns numpy
    (f0, timeaxis, sp, ap, mc) of len(wav)//hop + 1 frames, over the wav
    zero-padded to a multiple of ``pad_to`` samples (dvc_tpu pads to reuse
    compiled shapes; the port pads alike, so that it reads the same
    samples), cropped back.  ``use_native`` True (dvc_tpu's
    production route): Harvest F0 and D4C aperiodicity in the C++ engine
    on the host, CheapTrick and sp2mc on ``device``.  False: the
    all-device chain (``_analysis_chain``)."""
    from dvc_tpu_torch.native import world as native_world

    dev = resolve_device(device)
    hop = int(fs * frame_period / 1000.0)
    n_true = len(wav) // hop + 1
    wav = np.asarray(wav, np.float32)
    if not use_native:
        padded = wav
        if pad_to:
            padded = np.pad(wav, (0, int(np.ceil((len(wav) + 1) / pad_to)) * pad_to - len(wav)))
        with torch.inference_mode():
            out = _analysis_chain(torch.from_numpy(padded).to(dev), fs, frame_period, num_mcep)
        return tuple(x[:n_true].cpu().numpy() for x in out)
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


def world_decompose_batch(wavs: list[np.ndarray], fs: int, frame_period: float = 5.0,
                          num_mcep: int = 36, pad_to: int = 8000, max_batch: int = 16,
                          keep_sp_ap: bool = True, device: str | torch.device = "cuda"
                          ) -> list[tuple]:
    """Corpus-scale WORLD analysis on ``device``, many utterances a call
    (dvc_tpu/ops/world.py:579-669): the per-utterance contract of
    world_decompose, with Harvest (ops/harvest.py), CheapTrick and the
    mel-cepstrum batched over buckets of utterances zero-padded to a
    multiple of ``pad_to`` samples, ``max_batch`` at a time, and with
    ``keep_sp_ap`` the device D4C (ops/d4c.py).  Returns (f0, timeaxis, sp,
    ap, mc) per utterance; sp and ap are None when ``keep_sp_ap`` is False
    (preprocess-world stores f0 and the mel-cepstrum only)."""
    from dvc_tpu_torch.ops.d4c import d4c_batch
    from dvc_tpu_torch.ops.harvest import harvest_batch

    dev = resolve_device(device)
    hop = int(fs * frame_period / 1000.0)
    alpha = mcepalpha(fs)
    results: list = [None] * len(wavs)
    buckets: dict[int, list[int]] = {}
    for i, w in enumerate(wavs):
        if len(w) < 64:
            raise ValueError(f"utterance {i}: need >= 64 samples, got {len(w)}")
        buckets.setdefault(int(np.ceil((len(w) + 1) / pad_to)) * pad_to, []).append(i)

    with torch.inference_mode():
        for bucket, idxs in sorted(buckets.items()):
            n_pad_frames = bucket // hop + 1
            for lo in range(0, len(idxs), max_batch):
                chunk = idxs[lo:lo + max_batch]
                batch = np.zeros((len(chunk), bucket), np.float32)
                for r, i in enumerate(chunk):
                    batch[r, :len(wavs[i])] = wavs[i]
                batch_d = torch.from_numpy(batch).to(dev)
                f0_d = harvest_batch(batch_d, [len(wavs[i]) for i in chunk], fs, frame_period)
                # the harvest grid aligned to the sp/mc frame contract
                f0_d = F.pad(f0_d, (0, max(0, n_pad_frames - f0_d.shape[-1])))[:, :n_pad_frames]
                sp_d = spectral_envelope(batch_d, f0_d, fs, frame_period)
                mc_b = sp2mc(sp_d, num_mcep - 1, alpha).cpu().numpy()
                sp_b = ap_b = None
                if keep_sp_ap:
                    ap_b = d4c_batch(batch_d, f0_d, fs, frame_period,
                                     fft_size=2 * (sp_d.shape[-1] - 1), device=dev).cpu().numpy()
                    sp_b = sp_d.cpu().numpy()
                f0_b = f0_d.cpu().numpy()
                for r, i in enumerate(chunk):
                    n_true = len(wavs[i]) // hop + 1
                    timeaxis = (np.arange(n_true) * frame_period / 1000.0).astype(np.float32)
                    sp = ap = None
                    if keep_sp_ap:
                        sp, ap = sp_b[r, :n_true], ap_b[r, :n_true]
                    results[i] = (f0_b[r, :n_true], timeaxis, sp, ap, mc_b[r, :n_true])
    return results


def world_encode_data(wav: np.ndarray, fs: int, frame_period: float = 5.0,
                      num_mcep: int = 36, device: str | torch.device = "cuda"):
    """Reference world_encode_data (WORLD_processing.py:61-77)."""
    return world_decompose(wav, fs, frame_period, num_mcep, device=device)


def world_speech_synthesis(f0: np.ndarray, sp: np.ndarray, ap: np.ndarray, fs: int,
                           frame_period: float = 5.0, use_native: bool = True,
                           device: str | torch.device = "cuda") -> np.ndarray:
    """Reference world_speech_synthesis (WORLD_processing.py:99-106):
    len(f0) * hop float32 samples.  ``use_native`` True: the native
    engine's pulse-by-pulse synthesizer; False: the frame-rate device
    ``synthesize`` on ``device``."""
    from dvc_tpu_torch.native import world as native_world
    if not use_native:
        with torch.inference_mode():
            return synthesize(*(torch.from_numpy(np.array(x, np.float32)).to(
                resolve_device(device)) for x in (f0, sp, ap)), fs, frame_period).cpu().numpy()
    return native_world.synthesize(np.asarray(f0, np.float64), np.asarray(sp, np.float64),
                                   np.asarray(ap, np.float64), fs, frame_period,
                                   y_length=len(f0) * int(fs * frame_period / 1000.0))


def world_decode_mc(mc: np.ndarray, fs: int, device: str | torch.device = "cuda") -> np.ndarray:
    """Reference world_decode_mc (WORLD_processing.py:50-59): (T, order+1)
    mel-cepstra -> (T, fft_size//2+1) power envelope, float32."""
    x = torch.from_numpy(np.asarray(mc, np.float32)).to(resolve_device(device))
    return mc2sp(x, mcepalpha(fs), cheaptrick_fft_size(fs)).cpu().numpy()


# --- the device synthesis ----------------------------------------------------

def xla_cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Prefix sum over the last dim in the order of XLA's cumsum (a
    reduce-window that XLA rewrites into sequential sums over blocks of 16,
    whose block totals are summed the same way, recursively, and added
    back).  Float32 addition rounds each step, so only this order gives
    dvc_tpu's phase bit for bit, on the CPU and on a card alike."""
    n = x.shape[-1]
    if n <= block:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    m = -(-n // block)
    local = xla_cumsum(F.pad(x, (0, m * block - n)).reshape(*x.shape[:-1], m, block), block)
    before = F.pad(xla_cumsum(local[..., -1], block)[..., :-1], (1, 0))
    return (local + before[..., None]).reshape(*x.shape[:-1], m * block)[..., :n]


def synthesis_noise(seed: int, index: int | None, n: int) -> torch.Tensor:
    """(n,) float32 standard-normal draws: the noise of utterance ``index``
    of a synthesize_batch call (``None``: synthesize's one stream) under
    ``seed``, from a CPU ``torch.Generator`` seeded from (seed, index).
    dvc_tpu draws ``jax.random.normal`` under fold_in(PRNGKey(seed), index)
    (PRNGKey(seed) for synthesize); the parity tests put those draws here."""
    g = torch.Generator().manual_seed((seed * 1_000_003 + (0 if index is None else index + 1))
                                      % (1 << 63))
    return torch.randn(n, generator=g)


def _minimum_phase_ir(sp: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Power envelope (..., n_freq) -> minimum-phase impulse responses
    (..., fft_size) by the cepstral method."""
    logsp = 0.5 * torch.log(torch.clamp(sp, min=1e-30))  # log magnitude
    full = torch.cat([logsp, logsp[..., 1:-1].flip(-1)], dim=-1)
    ceps = torch.fft.ifft(full, dim=-1).real
    fold = torch.zeros(fft_size, dtype=torch.float32, device=sp.device)
    fold[0] = fold[fft_size // 2] = 1.0
    fold[1:fft_size // 2] = 2.0
    spec = torch.exp(torch.fft.fft(ceps * fold, dim=-1))
    return torch.fft.ifft(spec, dim=-1).real


def _synthesize_core(f0: torch.Tensor, sp: torch.Tensor, ap: torch.Tensor,
                     noise: torch.Tensor, fs: int, frame_period: float,
                     reciprocal: bool) -> torch.Tensor:
    """(B, N) f0, (B, N, n_freq) sp and ap, (B, N * hop) noise -> (B, N * hop)
    waveforms (dvc_tpu/ops/world.py:348-392, every row as its vmap does).

    dvc_tpu's synthesize_batch is a jitted program, in which XLA turns the
    division of f0 by fs into a product with fs's float32 reciprocal; its
    synthesize runs op by op and divides.  ``reciprocal`` picks which, so
    that the phase, and with it every pulse, is dvc_tpu's."""
    dev = sp.device
    bsz, n_frames, n_freq = sp.shape
    fft_size = 2 * (n_freq - 1)
    hop = int(fs * frame_period / 1000.0)
    total = n_frames * hop
    fs_t = torch.tensor(float(fs), dtype=torch.float32, device=dev)

    # excitation: pulses where the integrated instantaneous frequency
    # crosses an integer, scaled by sqrt(T0) for unit power a period
    f0_safe = torch.where(f0 > 0, f0, torch.zeros_like(f0)).repeat_interleave(hop, dim=-1)
    phase = xla_cumsum(f0_safe * (1.0 / fs_t) if reciprocal else f0_safe / fs_t)
    pulse = (torch.floor(phase) - torch.floor(F.pad(phase[..., :-1], (1, 0)))) > 0
    t0 = torch.where(f0 > 0, fs_t / torch.clamp(f0, min=1.0), torch.zeros_like(f0))
    pulse_sig = pulse.to(torch.float32) * torch.sqrt(
        torch.clamp(t0.repeat_interleave(hop, dim=-1), min=0.0))

    # the per-bin power split (d4c aperiodicity is an amplitude ratio)
    voiced = (f0 > 0)[..., None]
    ap2 = torch.clamp(ap, 1e-3, 1.0 - 1e-12) ** 2
    sp_per = torch.clamp(sp * (1.0 - ap2), min=1e-30)
    sp_apr = torch.where(voiced, sp * ap2, sp)
    ir_p = _minimum_phase_ir(sp_per, fft_size) * voiced.to(torch.float32)
    ir_n = _minimum_phase_ir(sp_apr, fft_size)

    # each frame's hop of excitation convolved with its responses, then
    # overlap-added at the frame rate (F.fold: the same order every run)
    n2 = 2 * fft_size
    seg_f = (torch.fft.rfft(pulse_sig.reshape(bsz, n_frames, hop), n=n2, dim=-1)
             * torch.fft.rfft(ir_p, n=n2, dim=-1)
             + torch.fft.rfft(noise.reshape(bsz, n_frames, hop), n=n2, dim=-1)
             * torch.fft.rfft(ir_n, n=n2, dim=-1))
    seg = torch.fft.irfft(seg_f, n=n2, dim=-1)                     # (B, N, 2 fft)
    length = (n_frames - 1) * hop + n2
    out = F.fold(seg.transpose(1, 2), output_size=(1, length), kernel_size=(1, n2),
                 stride=(1, hop)).reshape(bsz, length)
    return out[:, :total]


def synthesize(f0: torch.Tensor, sp: torch.Tensor, ap: torch.Tensor, fs: int = 16_000,
               frame_period: float = 5.0, seed: int = 0) -> torch.Tensor:
    """WORLD-style synthesis of one utterance on sp's device (the role of
    pyworld.synthesize): the pulse train shaped by the minimum-phase
    response of the periodic envelope sp (1 - ap^2), white noise by that of
    the aperiodic envelope sp ap^2 (all of sp where unvoiced), overlap-added
    at the frame rate.  (N,), (N, n_freq), (N, n_freq) -> (N * hop,)."""
    hop = int(fs * frame_period / 1000.0)
    noise = synthesis_noise(seed, None, f0.shape[-1] * hop).to(sp.device)
    f0, sp, ap = (x.to(sp.device, torch.float32) for x in (f0, sp, ap))
    return _synthesize_core(f0[None], sp[None], ap[None], noise[None], fs, frame_period,
                            reciprocal=False)[0]


def synthesize_batch(f0s: list, sps: list, aps: list, fs: int = 16_000,
                     frame_period: float = 5.0, pad_to_frames: int = 256, max_batch: int = 8,
                     seed: int = 0, device: str | torch.device = "cuda") -> list:
    """Corpus-scale WORLD synthesis on ``device``, many utterances a call
    (dvc_tpu/ops/world.py:422-486).  Utterances are bucketed by their frame
    count padded to ``pad_to_frames`` and run ``max_batch`` at a time.
    Padded frames are silent (f0 = 0, sp = 1e-30) and overlap-add past the
    true frames, so each cropped row equals the row synthesized alone on
    the same padded shape.  Utterance i's noise is synthesis_noise(seed, i,
    bucket * hop).  Returns float32 numpy waveforms of len(f0s[i]) * hop
    samples."""
    if not (len(f0s) == len(sps) == len(aps)):
        raise ValueError("f0s/sps/aps must be the same length")
    if not f0s:
        return []
    dev = resolve_device(device)
    hop = int(fs * frame_period / 1000.0)
    n_freq = int(np.asarray(sps[0]).shape[-1])
    results: list = [None] * len(f0s)
    buckets: dict[int, list[int]] = {}
    for i, f0 in enumerate(f0s):
        n = len(f0)
        if n == 0:
            raise ValueError(f"utterance {i}: empty f0 track")
        if np.asarray(sps[i]).shape != (n, n_freq) or np.asarray(aps[i]).shape != (n, n_freq):
            raise ValueError(f"utterance {i}: sp/ap shape mismatch")
        buckets.setdefault(-(-n // pad_to_frames) * pad_to_frames, []).append(i)

    for bucket, idxs in sorted(buckets.items()):
        for lo in range(0, len(idxs), max_batch):
            chunk = idxs[lo:lo + max_batch]
            b = len(chunk)
            f0_b = np.zeros((b, bucket), np.float32)
            sp_b = np.full((b, bucket, n_freq), 1e-30, np.float32)
            ap_b = np.full((b, bucket, n_freq), 1.0 - 1e-12, np.float32)
            for r, i in enumerate(chunk):
                n = len(f0s[i])
                f0_b[r, :n] = np.asarray(f0s[i], np.float32)
                sp_b[r, :n] = np.asarray(sps[i], np.float32)
                ap_b[r, :n] = np.asarray(aps[i], np.float32)
            noise = torch.stack([synthesis_noise(seed, i, bucket * hop) for i in chunk])
            with torch.inference_mode():
                out = _synthesize_core(*(torch.from_numpy(x).to(dev) for x in (f0_b, sp_b, ap_b)),
                                       noise.to(dev), fs, frame_period,
                                       reciprocal=True).cpu().numpy()
            for r, i in enumerate(chunk):
                results[i] = out[r, :len(f0s[i]) * hop]
    return results


# --- statistics and pitch conversion (WORLD_processing.py:120-192) -----------

def mcs_normalization_fit_transform(mcs: np.ndarray):
    mean = np.mean(mcs, axis=1, keepdims=True)
    std = np.std(mcs, axis=1, keepdims=True)
    return (mcs - mean) / std, mean, std


def logf0_statistics(f0s: np.ndarray) -> tuple[float, float]:
    log = np.ma.log(f0s)
    return float(log.mean()), float(log.std())


def pitch_conversion(f0: np.ndarray, mean_log_src: float, std_log_src: float,
                     mean_log_target: float, std_log_target: float) -> np.ndarray:
    """Log-Gaussian pitch transform (WORLD_processing.py:187-192)."""
    return np.exp((np.log(f0) - mean_log_src) / std_log_src * std_log_target
                  + mean_log_target)
