"""Batched D4C band aperiodicity on the device (port of dvc_tpu/ops/d4c.py).

The native engine (native/dvc_world.cpp:dvc_d4c, pyworld.d4c's role in the
reference's preprocessing/WORLD_processing.py:35) analyses one utterance
at a time in float64; dvc_tpu reformulates it for a batch of utterances
with static shapes, in float32, and so does the port, as PyTorch ops on
cuFFT and gathers.  Every data-dependent window length (the 4*T0
centroid and power windows, the 1.5*T0 LoveTrain window) is a masked
window on a fixed max-length row, gathered at data-dependent positions.
Per frame:

  * LoveTrain voicing override: the Blackman-windowed power ratio
    [0.1, 4] kHz / [0.1, 7.9] kHz; frames at or below ``threshold`` are
    forced fully aperiodic (Morise 2016 §2.2, pyworld D4COption.threshold);
  * static centroid: two Blackman 4*T0 windows at +-T0/4, Re{S* St} with
    the time-weighted pair spectrum;
  * smoothed power: a Hanning 4*T0 window, width-F0 rectangular smoothing;
  * static group delay: centroid / power, high-passed by subtracting its
    width-F0/2 smoothing;
  * coarse band aperiodicity: a Nuttall-windowed 3 kHz group-delay slice,
    FFT, the sorted power's cumulative sum, the share outside the
    coherent main lobe;
  * anchors (0 Hz, -60 dB) .. (fs/2, 0 dB) interpolated linearly onto the
    CheapTrick output grid, clamped to [0.001, 1).

dvc_tpu's gather-free window patches and dynamic-slice shifts are TPU
forms of the same reads; here they are gathers, which give the same
values.  The smoothing keeps dvc_tpu's block-local cumulative sums, which
hold float32 to float64-level agreement.  The native engine stays the
single-utterance path (native/world.py:d4c).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.utils.device import resolve_device

_EPS = 1e-12
_FLOOR_F0 = 47.0
_LOWEST_F0 = 40.0       # LoveTrain analysis floor
_FREQ_INTERVAL = 3000.0
_SMOOTH_BLOCK = 256     # > the widest smoothing window (f0_ceil 800 Hz -> ~205 bins)
_ROWS = 1 << 14         # frames analysed at once (bounds the working set)


def _next_pow2(n: int) -> int:
    return 1 << int(n - 1).bit_length()


def _trunc_round(x: torch.Tensor) -> torch.Tensor:
    """static_cast<long>(x + 0.5): truncation toward zero, not floor."""
    return torch.trunc(x + 0.5).to(torch.int64)


@dataclass(frozen=True)
class _Plan:
    fs: int
    fft_d4c: int
    n_freq: int
    n_bands: int
    fft_size_out: int
    n_out: int
    seg_half: int
    seg_win: np.ndarray
    boundary: int
    band_centers: np.ndarray   # (n_bands,) bin centers
    fft_lt: int
    lt_b0: int
    lt_b1: int
    lt_b2: int
    max_half_c: int            # centroid/power window max half-length
    max_half_lt: int           # LoveTrain window max half-length
    ax: np.ndarray             # (n_bands+2,) anchor frequencies


@functools.lru_cache(maxsize=8)
def _plan(fs: int, fft_size_out: int) -> _Plan:
    fft_d4c = 1 << (1 + int(np.ceil(np.log2(4.0 * fs / _FLOOR_F0 + 1.0))))
    n_bands = max(1, int(min(15000.0, fs / 2.0 - _FREQ_INTERVAL) / _FREQ_INTERVAL))
    seg_half = int(_FREQ_INTERVAL * fft_d4c / fs)
    seg_len = 2 * seg_half + 1
    i = np.arange(seg_len)
    seg_win = (0.355768 - 0.487396 * np.cos(2 * np.pi * i / (seg_len - 1))
               + 0.144232 * np.cos(4 * np.pi * i / (seg_len - 1))
               - 0.012604 * np.cos(6 * np.pi * i / (seg_len - 1)))
    fft_lt = _next_pow2(int(3.0 * fs / _LOWEST_F0 + 1.0))
    return _Plan(
        fs=fs, fft_d4c=fft_d4c, n_freq=fft_d4c // 2 + 1, n_bands=n_bands,
        fft_size_out=fft_size_out, n_out=fft_size_out // 2 + 1,
        seg_half=seg_half, seg_win=seg_win.astype(np.float32),
        boundary=int(fft_d4c * 8.0 / seg_len + 0.5),
        band_centers=np.array([int(_FREQ_INTERVAL * (b + 1) * fft_d4c / fs + 0.5)
                               for b in range(n_bands)], np.int64),
        fft_lt=fft_lt,
        lt_b0=int(np.ceil(100.0 * fft_lt / fs)),
        lt_b1=int(np.ceil(4000.0 * fft_lt / fs)),
        lt_b2=int(np.ceil(7900.0 * fft_lt / fs)),
        max_half_c=int(2.0 * fs / _FLOOR_F0 + 0.5),
        max_half_lt=int(1.5 * fs / _LOWEST_F0 + 0.5),
        ax=np.concatenate([[0.0], _FREQ_INTERVAL * (np.arange(n_bands) + 1), [fs / 2.0]]))


def _masked_window_gather(wavs: torch.Tensor, centers: torch.Tensor,
                          halves: torch.Tensor, max_half: int):
    """(B, N) waveforms, (B, F) centers and half-lengths -> (B, F,
    2*max_half+1) samples: sample j = center - half + i for i in [0,
    2*half], zero outside the waveform and outside each frame's own window
    (native sample()).  Returns (values, i, wlen), i the index in the
    window and wlen its length."""
    b, n = wavs.shape
    i = torch.arange(2 * max_half + 1, device=wavs.device)
    wlen = (2 * halves + 1)[..., None]
    j = (centers - halves)[..., None] + i
    inside = (j >= 0) & (j < n) & (i < wlen)
    v = torch.gather(wavs, 1, j.clamp(0, n - 1).reshape(b, -1)).reshape(j.shape)
    return torch.where(inside, v, 0.0), i, wlen


def _blackman_masked(i: torch.Tensor, wlen: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    x = i / (wlen - 1).clamp(min=1).to(dtype)
    w = 0.42 - 0.5 * torch.cos(2 * np.pi * x) + 0.08 * torch.cos(4 * np.pi * x)
    return torch.where(i < wlen, w, 0.0)


def _linear_smooth(arr: torch.Tensor, w_hz: torch.Tensor, fs: int, fft_d4c: int
                   ) -> torch.Tensor:
    """Width-``w_hz`` rectangular smoothing across frequency with
    fractional endpoint interpolation (native linear_smooth): (..., nf),
    (...) -> (..., nf).

    The native engine differences a global float64 cumulative sum; in
    float32 that difference is noise wherever the window sits in a
    low-power region.  As in dvc_tpu the sums are block-local: both
    endpoints of a window fall in the same or adjacent 256-bin blocks, so
    every difference is formed from within-block prefix sums plus at most
    two block totals.  Zero blocks padded on both sides reproduce the
    native engine's edge clamp.  Widths are clamped to one block (f0 above
    ~1560 Hz at 16 kHz, far outside the WORLD pitch range)."""
    lead, nf = arr.shape[:-1], arr.shape[-1]
    arr = arr.reshape(-1, nf)
    w_hz = w_hz.reshape(-1)
    rows, bsz = arr.shape[0], _SMOOTH_BLOCK
    w_bins = (w_hz / (fs / fft_d4c)).clamp(1.0, float(bsz - 1))
    n_blocks = -(-(nf + 2 * bsz) // bsz)
    ext_len = n_blocks * bsz
    blocks = F.pad(arr, (bsz, ext_len - nf - bsz)).reshape(rows, n_blocks, bsz)
    btot = blocks.sum(-1)
    cs2 = (torch.cumsum(blocks, -1) - blocks).reshape(rows, ext_len)  # exclusive prefixes
    btot_exp = btot.repeat_interleave(bsz, dim=-1)
    half = w_bins / 2.0
    k_hi = torch.floor(half).long()
    fr_hi = (half - k_hi)[:, None]
    k_lo = torch.floor(-half).long()
    fr_lo = (-half - k_lo)[:, None]
    i = torch.arange(nf, device=arr.device)[None, :]

    def shift(a, k):  # a[r, i + k[r]] in the padded frame
        return torch.gather(a, 1, i + bsz + k[:, None])

    def block_of(k):
        return (i + k[:, None] + bsz) // bsz

    b_lo0 = block_of(k_lo)
    t0 = shift(btot_exp, k_lo)            # btot[b_lo0]
    t1 = shift(btot_exp, k_lo + bsz)      # btot[b_lo0 + 1]

    def delta(b):  # base(b) - base(b_lo0) for b - b_lo0 in {0, 1, 2}
        d = b - b_lo0
        return torch.where(d >= 1, t0, 0.0) + torch.where(d >= 2, t1, 0.0)

    lo = (shift(cs2, k_lo) + delta(b_lo0)) * (1.0 - fr_lo) \
        + (shift(cs2, k_lo + 1) + delta(block_of(k_lo + 1))) * fr_lo
    hi = (shift(cs2, k_hi) + delta(block_of(k_hi))) * (1.0 - fr_hi) \
        + (shift(cs2, k_hi + 1) + delta(block_of(k_hi + 1))) * fr_hi
    out = (hi - lo) / w_bins.clamp(min=1e-9)[:, None]
    return out.reshape(*lead, nf)


def _love_train(plan: _Plan, f0: torch.Tensor, windows_lt) -> torch.Tensor:
    """(B, F) LoveTrain low-band power-ratio score per frame (native
    love_train_frame)."""
    halves = (1.5 * plan.fs / f0.clamp(min=_LOWEST_F0) + 0.5).to(torch.int64)
    v, i, wlen = windows_lt(halves)
    w = _blackman_masked(i, wlen, f0.dtype)
    re = v * w
    dc = re.sum(-1) / w.sum(-1).clamp(min=_EPS)
    re = re - dc[..., None] * w
    spec = torch.fft.rfft(re, n=plan.fft_lt, dim=-1)
    p = spec.real ** 2 + spec.imag ** 2
    k = torch.arange(p.shape[-1], device=p.device)
    band = (k >= plan.lt_b0 + 1) & (k <= min(plan.lt_b2, plan.fft_lt // 2))
    low = torch.where(band & (k <= plan.lt_b1), p, 0.0).sum(-1)
    full = torch.where(band, p, 0.0).sum(-1)
    score = low / full.clamp(min=_EPS)
    return torch.where(2 * halves + 1 > plan.fft_lt, 0.0, score)


def _one_utterance(plan: _Plan, frame_period_ms: float, threshold: float,
                   wavs: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """The per-utterance frame loop of native dvc_d4c, over a batch: (B,
    N), (B, F) -> (B, F, n_out) aperiodicity (dvc_tpu vmaps it), in the
    inputs' dtype (float32 as dvc_tpu; float64 as the native engine)."""
    dev, dt = wavs.device, f0.dtype
    n_frames = f0.shape[-1]
    # frame centers tpos*fs are fixed, in float64 on the host as the native
    # engine's; only the +-T0/4 centroid offsets depend on the data
    tpos_fs_np = np.arange(n_frames, dtype=np.float64) * (frame_period_ms / 1000.0) * plan.fs
    c_static = torch.from_numpy(np.trunc(tpos_fs_np + 0.5).astype(np.int64)).to(dev)
    tpos_fs = torch.from_numpy(tpos_fs_np).to(dev, dt)

    def windows(centers, halves, max_half):
        return _masked_window_gather(wavs, centers, halves, max_half)

    if threshold > 0.0:
        score = _love_train(plan, f0, lambda h: windows(c_static.expand_as(h), h,
                                                        plan.max_half_lt))
        cf0 = torch.where((f0 > 0.0) & (score <= threshold), 0.0, f0)
    else:
        cf0 = f0
    voiced = cf0 >= _FLOOR_F0
    safe_f0 = torch.where(voiced, cf0, 100.0)  # keeps the window math non-degenerate
    t0s = plan.fs / safe_f0
    halves = (2.0 * t0s + 0.5).to(torch.int64)

    # static centroid: Blackman 4*T0 windows at +-T0/4
    centroid = torch.zeros(*f0.shape, plan.n_freq, device=dev, dtype=dt)
    for off in (-1.0, 1.0):
        v, i, wlen = windows(_trunc_round(tpos_fs + off * t0s / 4.0), halves, plan.max_half_c)
        wave = v * _blackman_masked(i, wlen, dt)
        re = wave * (1.0 / torch.sqrt((wave * wave).sum(-1, keepdim=True).clamp(min=_EPS)))
        re_t = re * (i + 1.0) / plan.fs
        s = torch.fft.rfft(re, n=plan.fft_d4c, dim=-1)
        st = torch.fft.rfft(re_t, n=plan.fft_d4c, dim=-1)
        centroid = centroid + (s.real * st.real + s.imag * st.imag)

    # smoothed power: Hanning 4*T0, width-F0 smoothing
    v, i, wlen = windows(c_static.expand_as(halves), halves, plan.max_half_c)
    han = 0.5 - 0.5 * torch.cos(2 * np.pi * i / (wlen - 1).clamp(min=1).to(dt))
    spec = torch.fft.rfft(v * torch.where(i < wlen, han, 0.0), n=plan.fft_d4c, dim=-1)
    power = _linear_smooth(spec.real ** 2 + spec.imag ** 2, safe_f0, plan.fs, plan.fft_d4c)

    # static group delay, high-passed across frequency
    gd = centroid / power.clamp(min=_EPS)
    gd = gd - _linear_smooth(gd, safe_f0 / 2.0, plan.fs, plan.fft_d4c)

    # coarse aperiodicity per 3 kHz band
    coarse_db = []
    cut = max(0, plan.n_freq - 1 - plan.boundary)
    seg_win = torch.from_numpy(plan.seg_win).to(dev, dt)
    for center in plan.band_centers:
        k = np.arange(center - plan.seg_half, center + plan.seg_half + 1)
        valid = torch.from_numpy((k >= 0) & (k < plan.n_freq)).to(dev)
        kc = torch.from_numpy(np.clip(k, 0, plan.n_freq - 1)).to(dev)
        seg = torch.where(valid, gd[..., kc], 0.0) * seg_win
        spec_b = torch.fft.rfft(seg, n=plan.fft_d4c, dim=-1)
        p = torch.sort(spec_b.real ** 2 + spec_b.imag ** 2, dim=-1).values
        csum = torch.cumsum(p, -1)
        apw = csum[..., cut] / csum[..., -1].clamp(min=_EPS)
        coarse_db.append((10.0 * torch.log10(apw.clamp(min=1e-12))).clamp(-60.0, 0.0))

    # the coarse dB anchors interpolated onto the output grid
    av = torch.stack([torch.full_like(f0, -60.0)] + coarse_db
                     + [torch.full_like(f0, -1e-12)], dim=-1)
    f_out = np.arange(plan.n_out, dtype=np.float64) * plan.fs / plan.fft_size_out
    seg_idx = np.clip(np.searchsorted(plan.ax, f_out, side="right") - 1, 0, plan.n_bands)
    dx = plan.ax[seg_idx + 1] - plan.ax[seg_idx]
    a = np.clip((f_out - plan.ax[seg_idx]) / np.maximum(dx, _EPS), 0.0, 1.0)
    lo_i = torch.from_numpy(seg_idx).to(dev)
    db_row = av[..., lo_i] * torch.from_numpy((1.0 - a).astype(np.float32)).to(dev, dt) \
        + av[..., lo_i + 1] * torch.from_numpy(a.astype(np.float32)).to(dev, dt)
    # the native engine caps at 1-1e-12 (double); in float32 the largest
    # float below 1 plays its role: strictly < 1, so 1 - ap^2 stays >= 0
    cap = (1.0 - 1e-12 if dt == torch.float64
           else float(np.nextafter(np.float32(1.0), np.float32(0.0))))
    ap = (10.0 ** (db_row / 20.0)).clamp(0.001, cap)
    return torch.where(voiced[..., None], ap, cap)


def d4c_batch(wavs, f0s, fs: int = 16_000, frame_period_ms: float = 5.0,
              fft_size: int | None = None, threshold: float = 0.85,
              device: str | torch.device = "cuda",
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched D4C aperiodicity for (B, N) waveforms and (B, F) F0 tracks
    (numpy or tensors), on ``device``.

    The per-frame contract of native dvc_d4c and pyworld.d4c: (B, F,
    fft_size//2+1) aperiodicity in [0.001, 1); unvoiced frames (f0 = 0, or
    voiced frames failing the LoveTrain check at ``threshold``) are fully
    aperiodic.  Rows may be zero-padded: padded samples read as silence and
    padded frames (f0 = 0) come back fully aperiodic.  ``dtype`` is the
    computation's and the result's: float32 as dvc_tpu runs it, float64 as
    the native engine does."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    dev = resolve_device(device)
    wavs = torch.as_tensor(wavs, dtype=dtype).to(dev)
    f0s = torch.as_tensor(f0s, dtype=dtype).to(dev)
    if wavs.dim() == 1:
        wavs = wavs[None]
    if f0s.dim() == 1:
        f0s = f0s[None]
    if wavs.shape[0] != f0s.shape[0]:
        raise ValueError(f"batch mismatch: {wavs.shape[0]} wavs vs "
                         f"{f0s.shape[0]} f0 tracks")
    if fft_size is None:
        from dvc_tpu_torch.ops.world import cheaptrick_fft_size
        fft_size = cheaptrick_fft_size(fs)
    plan = _plan(int(fs), int(fft_size))
    step = max(1, _ROWS // max(1, f0s.shape[1]))  # utterances a pass
    with torch.inference_mode():
        return torch.cat([_one_utterance(plan, float(frame_period_ms), float(threshold),
                                         wavs[lo:lo + step], f0s[lo:lo + step])
                          for lo in range(0, wavs.shape[0], step)])
