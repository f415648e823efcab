"""Batched Harvest F0 estimation on the device (port of dvc_tpu/ops/harvest.py).

dvc_tpu's port of the native Harvest engine (native/dvc_world.cpp:
dvc_harvest_stage), the algorithm the reference gets from pyworld.harvest
(preprocessing/WORLD_processing.py:33), reformulated so that a whole batch
of utterances runs at once:

  * decimation        -> one strided ``F.conv1d`` over the batch;
  * channel filtering -> precomputed Nuttall band-pass rfft spectra (the
                         filter delay baked in as a phase ramp), one batched
                         irfft a block of channels;
  * event trains      -> the four zero-crossing/peak/dip interval tracks in
                         per-sample dense form, read on the 1 ms candidate
                         grid;
  * candidate merge   -> a loop over channels in index order (the native
                         serial merge's dedup);
  * refinement        -> harmonic-weighted instantaneous frequency from
                         Blackman window/derivative-window rfft pairs, the
                         window length quantized to half-octave buckets (the
                         one deliberate deviation from the native engine:
                         each bucket is one fixed-shape rfft);
  * contour fixing    -> jump and short-run removal vectorized; the
                         forward/backward extension as chains of unvoiced
                         frames advanced in lockstep, and the zero-phase
                         Butterworth smoother as a log-depth scan of affine
                         maps with per-segment resets.

dvc_tpu avoids gathers and searchsorted, which are slow on a TPU: it reads
the event tracks on the grid through a bounded lookback window of strided
patches (``_grid_eval_uniform``).  The port reads them with
``torch.searchsorted`` and gathers, and keeps that window's result: where
an event gap is longer than the lookback (in silences) the bracketing pair
is the one dvc_tpu's window finds, not the searchsorted twin's
(``_interval_track`` + ``_interp_track_grid``, which serves grids whose
sample stride is not an integer, as in dvc_tpu).  The harmonic bins are
read by a gather where dvc_tpu uses a one-hot matmul; both pick exactly.

Everything is float32 (the decimation convolution with TF32 off), so the
output is held to dvc_tpu's by tolerance, not bit for bit.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32

CAND_PERIOD = 0.001  # seconds: the internal candidate grid (native: cand_period)
_CH_PER_OCT = 24.0
_REFINE_BUCKETS_PER_OCT = 2  # half-octave window-length quantization
_NEG = -1e30  # "no track here" sentinels, as dvc_tpu's
_POS = 1e30
_LOOKBACK = 256  # floor on the tm-lookahead window (dvc_tpu/ops/harvest.py:233-238)
_MAX_SLOTS = int(os.environ.get("DVC_HARVEST_MAX_SLOTS", "32"))
# candidate slots kept after the channel merge (a dense prefix by
# construction); the merge's high-water mark is kept so that an input that
# would overflow the cap is detectable (merge_slot_high_water)

_last_merge_slots: list = [None]  # device scalar from the last harvest call


def merge_slot_high_water() -> int | None:
    """Max candidates a frame the channel merge produced in the last
    harvest_batch call.  If it reaches _MAX_SLOTS the truncation may have
    dropped mutually 3%-separated candidates: re-run with
    DVC_HARVEST_MAX_SLOTS raised."""
    v = _last_merge_slots[0]
    return None if v is None else int(v)


def _next_pow2(n: int) -> int:
    return 1 << int(n - 1).bit_length()


def _nuttall(x: np.ndarray) -> np.ndarray:
    """Nuttall window on x in [0, 1] (the native nuttall())."""
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * x)
            + 0.144232 * np.cos(4 * np.pi * x)
            - 0.012604 * np.cos(6 * np.pi * x))


def _blackman(x: np.ndarray) -> np.ndarray:
    return 0.42 - 0.5 * np.cos(2 * np.pi * x) + 0.08 * np.cos(4 * np.pi * x)


@dataclass(frozen=True, repr=False)
class _Plan:
    """Host-side (numpy) precomputation for one (n, fs, floor, ceil) shape
    (dvc_tpu/ops/harvest.py:73-160)."""
    n: int
    fs: int
    f0_floor: float
    f0_ceil: float
    ratio: int
    afs: float
    m: int                      # analysis-rate sample count
    n1: int                     # 1 ms candidate-grid frames
    fft_size: int
    n_ch: int
    ch_block: int               # channels a block
    dec_fir: np.ndarray         # (2*half+1,)
    dec_half: int
    bank: np.ndarray            # (n_ch_pad, K) complex64
    bf0: np.ndarray             # (n_ch_pad,)
    buckets: tuple              # tuple of (half, fft_b, win, dwin)
    max_half: int


@functools.lru_cache(maxsize=8)
def _plan(n: int, fs: int, f0_floor: float, f0_ceil: float) -> _Plan:
    ratio = max(1, fs // 8000)
    afs = fs / ratio
    m = n // ratio
    n1 = int(n / fs / CAND_PERIOD) + 1
    margin = int(4.0 * afs / f0_floor) + 1
    fft_size = _next_pow2(m + 2 * margin)
    n_ch = 1 + int(np.log2(f0_ceil / f0_floor) * _CH_PER_OCT)

    # decimation FIR (native decimate(): windowed sinc, cutoff 0.45/ratio)
    if ratio > 1:
        dec_half = 32 * ratio
        cutoff = 0.45 / ratio
        t = np.arange(2 * dec_half + 1, dtype=np.float64) - dec_half
        sinc = np.where(t == 0.0, 2.0 * cutoff,
                        np.sin(2 * np.pi * cutoff * t) / (np.pi * np.where(t == 0, 1.0, t)))
        fir = sinc * _blackman(np.arange(2 * dec_half + 1) / (2 * dec_half))
        fir /= fir.sum()
    else:
        dec_half = 0
        fir = np.ones(1, np.float64)

    # channel band-pass rfft spectra with the filter-delay compensation
    # (time shift by +half) baked in as a phase ramp e^{+j 2 pi k half / N}
    kk = np.arange(fft_size // 2 + 1)
    nch_pad = -(-n_ch // 8) * 8
    bank = np.zeros((nch_pad, fft_size // 2 + 1), np.complex64)
    bf0s = np.zeros(nch_pad, np.float64)
    for ch in range(n_ch):
        bf0 = f0_floor * 2.0 ** ((ch + 1) / _CH_PER_OCT)
        bf0s[ch] = bf0
        if bf0 > f0_ceil * 1.1:
            continue
        half = int(afs / bf0 * 2.0 + 0.5)
        flen = 2 * half + 1
        if flen >= fft_size:
            continue
        taps = np.zeros(fft_size, np.float64)
        i = np.arange(flen)
        taps[:flen] = _nuttall(i / (flen - 1)) * np.cos(2 * np.pi * bf0 * (i - half) / afs)
        spec = np.fft.rfft(taps) * np.exp(2j * np.pi * kk * half / fft_size)
        bank[ch] = spec.astype(np.complex64)

    # refinement window buckets: a half-octave grid over [floor, ceil]
    n_b = int(np.ceil(np.log2(f0_ceil / f0_floor) * _REFINE_BUCKETS_PER_OCT))
    buckets = []
    max_half = 0
    for b in range(n_b):
        fc = f0_floor * 2.0 ** ((b + 0.5) / _REFINE_BUCKETS_PER_OCT)
        half = int(1.5 * afs / fc + 0.5)
        wlen = 2 * half + 1
        fft_b = _next_pow2(wlen) * 2
        x = np.arange(wlen) / (wlen - 1)
        win = _blackman(x)
        wpad = np.concatenate([[0.0], win, [0.0]])
        dwin = (wpad[2:] - wpad[:-2]) * 0.5 * afs  # native derivative window
        buckets.append((half, fft_b, win.astype(np.float32), dwin.astype(np.float32)))
        max_half = max(max_half, half)

    return _Plan(n=n, fs=fs, f0_floor=f0_floor, f0_ceil=f0_ceil, ratio=ratio, afs=afs, m=m,
                 n1=n1, fft_size=fft_size, n_ch=n_ch, ch_block=8, dec_fir=fir,
                 dec_half=dec_half, bank=bank, bf0=bf0s, buckets=tuple(buckets),
                 max_half=max_half)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on like's device: a Python float meets a float32
    array as a float32 value in jax, and a division by it stays a division."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


# --------------------------------------------------------------- events -----

def _interval_track(cross: torch.Tensor, loc: torch.Tensor):
    """Per-sample interval track from crossing events (..., E): (ev, tm,
    fv), where ev marks an event that has a next event, tm the interval's
    midpoint time and fv 1/interval (native zero_crossings' (t, f0) pairs
    at the first event's position)."""
    e = cross.shape[-1]
    idx = torch.arange(e, device=cross.device)
    nxt = _suffix_min(torch.where(cross, idx, e + 1))
    nxt_after = F.pad(nxt[..., 1:], (0, 1), value=e + 1)
    has_next = nxt_after < e
    loc_next = torch.gather(loc, -1, torch.where(has_next, nxt_after, 0))
    tm = 0.5 * (loc + loc_next)
    fv = _f32(1.0, loc) / torch.clamp(loc_next - loc, min=1e-12)
    return cross & has_next, tm, fv


def _interp_track_grid(ev: torch.Tensor, tm: torch.Tensor, fv: torch.Tensor,
                       grid: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of (R, E) tracks onto (G,) grid times (native
    interp_track(): 0 outside [first, last] track point or with fewer than
    2 points; otherwise the bracketing pair).  Returns (R, G)."""
    r, e = ev.shape
    idx = torch.arange(e, device=ev.device).expand(r, e)
    nxt_val = _suffix_min(torch.where(ev, tm, torch.inf))          # non-decreasing
    nxt_idx = _suffix_min(torch.where(ev, idx, e + 1))
    prv_idx = torch.cummax(torch.where(ev, idx, -1), dim=-1).values
    gq = grid.expand(r, -1).contiguous()
    p = torch.clamp(torch.searchsorted(nxt_val.contiguous(), gq, side="left"), 0, e - 1)
    j2 = torch.gather(nxt_idx, -1, p)  # the first track point with tm >= t
    j2_ok = j2 < e
    j2c = torch.where(j2_ok, j2, 0)
    j1 = torch.gather(prv_idx, -1, torch.clamp(j2c - 1, min=0))  # the one before it
    j1_ok = (j1 >= 0) & (j2c >= 1)
    j1c = torch.where(j1_ok, j1, 0)
    t0, t1 = torch.gather(tm, -1, j1c), torch.gather(tm, -1, j2c)
    f0v, f1v = torch.gather(fv, -1, j1c), torch.gather(fv, -1, j2c)
    a = torch.where(t1 > t0, (gq - t0) / torch.clamp(t1 - t0, min=1e-12), 0.0)
    v = f0v * (1.0 - a) + f1v * a
    valid = j2_ok & j1_ok & (ev.sum(-1, keepdim=True) >= 2) & (gq >= 0)
    return torch.where(valid, v, 0.0)


def _track_fields(cross: torch.Tensor, loc: torch.Tensor):
    """Per-sample track fields: tm (the interval midpoint, _NEG where no
    track starts) and fv (1/interval).  Event locs are non-decreasing in
    position, so the suffix-min of event locs is the next event's loc."""
    nl = _suffix_min(torch.where(cross, loc, _POS))
    nl_after = F.pad(nl[..., 1:], (0, 1), value=_POS)
    ev = cross & (nl_after < _POS / 2)
    tm = torch.where(ev, 0.5 * (loc + nl_after), _NEG)
    fv = _f32(1.0, loc) / torch.clamp(nl_after - loc, min=1e-12)
    return tm, fv


def _grid_eval_uniform(tm: torch.Tensor, fv: torch.Tensor, stride: int, grid: torch.Tensor,
                       lookback: int = _LOOKBACK) -> torch.Tensor:
    """dvc_tpu's _grid_eval_uniform (dvc_tpu/ops/harvest.py:293-402) by
    searchsorted and gathers.  tm/fv: (R, E) from _track_fields; grid (G,)
    with grid[g] at sample g*stride.  Returns (R, G).

    The bracketing pair for grid time t is (j2, its predecessor track).
    dvc_tpu takes j2 as the first track with tm >= t inside the lookback
    window [g*stride - lookback, g*stride - 1], and else the first track at
    or after g*stride, whatever its tm.  Track tms are non-decreasing in
    position (consecutive intervals' midpoints), so the tracks with tm >= t
    are those at or after one position p_t, found by a searchsorted over
    each position's next-track tm; the window's j2 is then the first track
    at or after max(g*stride - lookback, p_t), if it lies before g*stride."""
    r, e = tm.shape
    g = grid.shape[0]
    dev = tm.device
    is_tr = tm > _NEG / 2
    pos = torch.arange(e, device=dev).expand(r, e)
    nxt = _suffix_min(torch.where(is_tr, pos, e))  # first track at or after p; e: none
    prv = F.pad(torch.cummax(torch.where(is_tr, pos, -1), dim=-1).values[:, :-1], (1, 0),
                value=-1)                           # last track strictly before p
    ptm = torch.where(prv >= 0, torch.gather(tm, -1, prv.clamp(min=0)), _NEG)
    pfv = torch.gather(fv, -1, prv.clamp(min=0))

    z_tm = torch.where(nxt < e, torch.gather(tm, -1, nxt.clamp(max=e - 1)),
                       torch.inf)         # next track's tm; non-decreasing
    sg = torch.arange(g, device=dev) * stride     # each grid time's sample
    gq = grid.expand(r, -1).contiguous()
    p_t = torch.searchsorted(z_tm.contiguous(), gq, side="left")
    start = torch.maximum((sg - lookback).clamp(min=0).expand(r, -1), p_t)
    nxt_e = F.pad(nxt, (0, 1), value=e)
    j2 = torch.gather(nxt_e, -1, start.clamp(max=e))
    found = (j2 < sg) & (j2 < e)                    # inside the window
    after = torch.gather(nxt_e, -1, sg.clamp(max=e).expand(r, -1))
    sel = torch.where(found, j2, after)             # e: no track (past the signal too)
    ok = sel < e
    selc = sel.clamp(max=e - 1)
    tm2 = torch.where(ok, torch.gather(tm, -1, selc), _NEG)
    fv2 = torch.gather(fv, -1, selc)
    tm1 = torch.where(ok, torch.gather(ptm, -1, selc), _NEG)
    fv1 = torch.gather(pfv, -1, selc)

    valid = (tm2 > _NEG / 2) & (tm2 < _POS / 2) & (tm1 > _NEG / 2)
    a = torch.where(tm2 > tm1, (gq - tm1) / torch.clamp(tm2 - tm1, min=1e-12), 0.0)
    v = fv1 * (1.0 - a) + fv2 * a
    return torch.where(valid, v, 0.0)


def _channel_candidates(filtered: torch.Tensor, bf0: torch.Tensor, afs: float,
                        grid: torch.Tensor, f0_floor: float, f0_ceil: float) -> torch.Tensor:
    """(CB, B, M) filtered block -> (CB, B, G) per-channel candidate f0: the
    four event trains (falling/rising zero crossings of the signal, peaks
    and dips as crossings of its first difference) must all interpolate to
    within 20% relative deviation, inside the channel band [bf0/2, 2 bf0]
    (native dvc_world.cpp:555-627)."""
    s = filtered
    one, afs_t = _f32(1.0, s), _f32(afs, s)
    a, b = s[..., :-1], s[..., 1:]
    i = torch.arange(s.shape[-1] - 1, dtype=s.dtype, device=s.device)
    loc_s = (i + a / torch.where(a == b, one, a - b)) / afs_t
    d = F.pad(s[..., 1:] - s[..., :-1], (0, 1))  # native dif_at: a trailing implicit 0
    da, db = d[..., :-1], d[..., 1:]
    loc_d = (i + da / torch.where(da == db, one, da - db)) / afs_t
    crosses = (
        ((a > 0.0) & (b <= 0.0), loc_s),    # falling
        ((a < 0.0) & (b >= 0.0), loc_s),    # rising
        ((da > 0.0) & (db <= 0.0), loc_d),  # peaks
        ((da < 0.0) & (db >= 0.0), loc_d),  # dips
    )
    cb, bsz = s.shape[0], s.shape[1]
    stride_f = CAND_PERIOD * afs
    stride = int(round(stride_f))
    if abs(stride_f - stride) < 1e-9:
        # the four trains stacked on the row axis: one pass covers them all;
        # the lookback covers one ring interval of the lowest channel with a
        # 2x margin, as dvc_tpu derives it from the plan
        fields = [_track_fields(cr, loc) for cr, loc in crosses]
        tm_all = torch.stack([f[0] for f in fields]).reshape(4 * cb * bsz, -1)
        fv_all = torch.stack([f[1] for f in fields]).reshape(4 * cb * bsz, -1)
        lookback = max(_LOOKBACK, -(-int(2.0 * afs / f0_floor + 1) // 64) * 64)
        v = _grid_eval_uniform(tm_all, fv_all, stride, grid, lookback)
    else:
        vs = []
        for cr, loc in crosses:
            ev, tm, fv = _interval_track(cr, loc)
            vs.append(_interp_track_grid(ev.reshape(cb * bsz, -1), tm.reshape(cb * bsz, -1),
                                         fv.reshape(cb * bsz, -1), grid))
        v = torch.stack(vs)
    v = v.reshape(4, cb, bsz, -1).permute(1, 2, 3, 0)  # (CB, B, G, 4)

    ok = torch.all(v > 0.0, dim=-1)
    mean = torch.mean(v, dim=-1)
    dev = torch.sqrt(torch.sum((v - mean[..., None]) ** 2, dim=-1) / _f32(3.0, v)) \
        / torch.clamp(mean, min=1e-12)
    bf = bf0[:, None, None]
    band = (mean >= bf * 0.5) & (mean <= bf * 2.0)
    inside = (mean >= f0_floor) & (mean <= f0_ceil)
    return torch.where(ok & (dev <= 0.2) & band & inside, mean, 0.0)


# ------------------------------------------------------------ candidates ----

def _merge_channels(cols: torch.Tensor, max_c: int):
    """Serial-in-channel-order dedup merge (native dvc_world.cpp:633-649):
    (C, B, G) -> cand (B, G, max_c), n_c (B, G)."""
    _, b, g = cols.shape
    slots = torch.arange(max_c, device=cols.device)
    cand = cols.new_zeros((b, g, max_c))
    n_c = torch.zeros((b, g), dtype=torch.int64, device=cols.device)
    for m in cols:
        live = slots < n_c[..., None]
        dup = torch.any(live & ((cand - m[..., None]).abs() < 0.03 * m[..., None]), dim=-1)
        ins = (m > 0.0) & ~dup & (n_c < max_c)
        cand = torch.where((slots == n_c[..., None]) & ins[..., None], m[..., None], cand)
        n_c = n_c + ins
    return cand, n_c


# ------------------------------------------------------------ refinement ----

def _refine(plan: _Plan, y_pad: torch.Tensor, cand: torch.Tensor):
    """Harmonic-weighted instantaneous-frequency refinement and score
    (native refine_candidate, dvc_world.cpp:158-280) with the window length
    quantized to half-octave buckets.  y_pad: (B, M + 2 max_half) the
    zero-padded analysis signal; cand: (B, G, C) candidate f0 (0: empty).
    Returns (refined, score), both (B, G, C)."""
    afs, n1 = plan.afs, plan.n1
    f0 = cand
    bb, gg, cc = f0.shape
    dev = f0.device
    bkt = torch.clamp((torch.log2(torch.clamp(f0, min=1e-6) / _f32(plan.f0_floor, f0))
                       * _REFINE_BUCKETS_PER_OCT).to(torch.int32), 0, len(plan.buckets) - 1)
    n_harm = torch.clamp((_f32(afs / 2.0, f0) / torch.clamp(f0, min=1e-6)).to(torch.int32),
                         max=6)
    h = torch.arange(1, 7, dtype=torch.float32, device=dev)
    odd = torch.tensor([1., 0., 1., 0., 1., 0.], device=dev)
    stride_f = CAND_PERIOD * afs
    stride = int(round(stride_f))
    uniform = abs(stride_f - stride) < 1e-9
    centers = torch.from_numpy(np.round(np.arange(n1) * CAND_PERIOD * afs).astype(np.int64)).to(dev)

    refined = torch.zeros_like(f0)
    score = torch.zeros_like(f0)
    for b_i, (half, fft_b, win, dwin) in enumerate(plan.buckets):
        wlen = 2 * half + 1
        if uniform:  # strided windows: an unfold, zero-padded past the end
            x = y_pad[:, plan.max_half - half:]
            x = F.pad(x, (0, max(0, (n1 - 1) * stride + wlen - x.shape[-1])))
            seg = x.unfold(-1, wlen, stride)[:, :n1]
        else:
            # a window past the end reads the last sample, as jax clamps a
            # gather's indices
            idx = centers[:, None] - half + torch.arange(wlen, device=dev)[None, :] + plan.max_half
            seg = y_pad[:, idx.clamp(max=y_pad.shape[-1] - 1)]  # (B, G, wlen)
        rm = torch.fft.rfft(seg * torch.from_numpy(win).to(dev), n=fft_b, dim=-1)
        rd = torch.fft.rfft(seg * torch.from_numpy(dwin).to(dev), n=fft_b, dim=-1)
        freq_res = afs / fft_b

        k = torch.round(f0[..., None] * h / _f32(freq_res, f0)).to(torch.int64)
        k_ok = (k > 0) & (k < fft_b // 2)
        h_ok = (h <= n_harm[..., None]) & k_ok
        kc = torch.clamp(k, 0, fft_b // 2)
        flat = kc.reshape(bb, gg, cc * 6)
        sm = torch.gather(rm, -1, flat).reshape(bb, gg, cc, 6)
        sd = torch.gather(rd, -1, flat).reshape(bb, gg, cc, 6)
        smr, smi, sdr, sdi = sm.real, sm.imag, sd.real, sd.imag
        power = torch.clamp(smr ** 2 + smi ** 2, min=1e-30)
        amp = torch.sqrt(power)
        instf = kc.to(torch.float32) * _f32(freq_res, f0) + (sdr * smi - sdi * smr) \
            / (_f32(2.0 * np.pi, f0) * power)
        amp = torch.where(h_ok, amp, 0.0)
        num = torch.sum(amp * instf, dim=-1)
        den = torch.sum(amp * h, dim=-1)
        ref_b = num / torch.clamp(den, min=1e-12)
        wsum = torch.sum(amp, dim=-1)
        dev_b = torch.sum(amp * torch.abs(instf / h - ref_b[..., None]), dim=-1) \
            / (torch.clamp(wsum, min=1e-12) * torch.clamp(ref_b, min=1e-12))
        sc_b = _f32(1.0, f0) / (dev_b + 1e-6)
        nh_eff = torch.sum(h_ok, dim=-1)
        odd_frac = torch.sum(amp * odd, dim=-1) / torch.clamp(wsum, min=1e-12)
        sc_b = torch.where(nh_eff >= 2, sc_b * torch.clamp(odd_frac / _f32(0.2, f0), max=1.0),
                           sc_b)
        ok = (nh_eff >= 1) & (den > 1e-12) & (ref_b >= plan.f0_floor) & (ref_b <= plan.f0_ceil)
        sc_b = torch.where(ok, sc_b, 0.0)
        sel = (bkt == b_i) & (f0 > 0.0)
        refined = torch.where(sel, torch.where(ok, ref_b, 0.0), refined)
        score = torch.where(sel, sc_b, score)
    return refined, score


def _dedup_refined(cand: torch.Tensor, score: torch.Tensor):
    """Post-refinement near-duplicate merge keeping the best score (native
    dvc_world.cpp:664-679), a loop over the slot axis."""
    max_c = cand.shape[-1]
    slots = torch.arange(max_c, device=cand.device)
    f, s = cand, score
    for j in range(max_c):
        fj, sj = f[..., j], s[..., j]
        close = (slots > j) & (f > 0.0) & (fj[..., None] > 0.0) \
            & ((f - fj[..., None]).abs() < 0.03 * fj[..., None])
        s_best, arg = torch.max(torch.where(close, s, -torch.inf), dim=-1)
        take = (s_best > sj) & torch.any(close, dim=-1)
        f_best = torch.gather(f, -1, arg[..., None])[..., 0]
        new_fj = torch.where(take, f_best, fj)
        new_sj = torch.where(take, torch.maximum(s_best, sj), sj)
        isj = slots == j
        f = torch.where(close, 0.0, torch.where(isj, new_fj[..., None], f))
        s = torch.where(close, 0.0, torch.where(isj, new_sj[..., None], s))
    return f, s


# ---------------------------------------------------------- contour fixes ---

def _closest_ratio(neighbor: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Per candidate slot, min over the neighbour frame's candidates of
    |c - f| / f (1e30 where the neighbour has none).  (B, G, C) -> (B, G, C)."""
    r = (neighbor[..., None, :] - f[..., :, None]).abs() \
        / torch.clamp(f[..., :, None], min=1e-12)
    return torch.min(torch.where(neighbor[..., None, :] > 0.0, r, 1e30), dim=-1).values


def _run_lengths(v: torch.Tensor) -> torch.Tensor:
    """Per-frame length of the voiced run containing it (0 where unvoiced);
    v: (..., G) bool."""
    g = v.shape[-1]
    idx = torch.arange(g, device=v.device)
    prev = F.pad(v[..., :-1], (1, 0), value=False)
    nxt = F.pad(v[..., 1:], (0, 1), value=False)
    start = torch.cummax(torch.where(v & ~prev, idx, -1), dim=-1).values
    end = _suffix_min(torch.where(v & ~nxt, idx, g + 1))
    return torch.where(v, end - start + 1, 0)


def _extend(f0: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Forward candidate-pool extension of voiced sections (native
    dvc_world.cpp:759-771; the backward pass is this on reversed arrays):
    each unvoiced frame after a filled one takes its candidate nearest the
    carried pitch within 9%, until none is.  f0 (B, G), cand (B, G, C).

    dvc_tpu scans all G frames.  Only the chains that start right after a
    voiced frame and run through the unvoiced frames behind it carry state,
    so the port advances every chain of the batch in lockstep, one frame a
    step, until all have ended: as many steps as the longest chain, not G."""
    bsz, g = f0.shape
    voiced = f0 > 0.0
    start = ~voiced & F.pad(voiced[:, :-1], (1, 0), value=False)
    b_idx, pos = torch.nonzero(start, as_tuple=True)
    out = f0.clone()
    if b_idx.numel() == 0:
        return out
    ref = f0[b_idx, pos - 1]
    alive = torch.ones_like(b_idx, dtype=torch.bool)
    step = 0
    while True:
        at = pos.clamp(max=g - 1)
        live = alive & (pos < g) & ~voiced[b_idx, at]
        ci = cand[b_idx, at]                                  # (chains, C)
        diff = (ci - ref[:, None]).abs()
        okc = (ci > 0.0) & (diff / torch.clamp(ref, min=1e-12)[:, None] <= 0.09)
        d_min, arg = torch.min(torch.where(okc, diff, torch.inf), dim=-1)
        m = torch.where(live & (d_min < torch.inf), torch.gather(ci, -1, arg[:, None])[:, 0],
                        0.0)
        out[b_idx[live], at[live]] = m[live]
        alive = live & (m > 0.0)
        ref, pos = m, pos + 1
        step += 1
        if step % 16 == 0 and not bool(alive.any()):
            return out


_FC = 0.03  # the smoother's cutoff on the 1 kHz grid


def _butter_coefficients() -> tuple[float, float, float, float, float]:
    k = np.tan(np.pi * _FC)
    norm = 1.0 + np.sqrt(2.0) * k + k * k
    b0 = k * k / norm
    a1 = 2.0 * (k * k - 1.0) / norm
    a2 = (1.0 - np.sqrt(2.0) * k + k * k) / norm
    return b0, 2.0 * b0, b0, a1, a2


def _iir_segments(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """One direction of the smoother (dvc_tpu/ops/harvest.py:713-733): the
    2nd-order Butterworth over (B, G) frames, its state reset to the
    current input wherever ``start`` marks a segment's first frame.

    dvc_tpu scans the frames one by one.  The filter is linear between
    resets, so each frame's step is an affine map of the state (y_t, the
    carried y): S_t = M_t S_t-1 + v_t, with M_t = 0 at a reset.  The maps
    compose associatively, and a log-depth prefix scan (Hillis-Steele) over
    them gives every frame's state at once, in float64."""
    b0, b1, b2, a1, a2 = _butter_coefficients()
    bsz, g = x.shape
    xd = x.to(torch.float64)
    st = start
    x_prev = F.pad(xd[:, :-1], (1, 0))
    x_prev2 = F.pad(xd[:, :-2], (2, 0))
    st_prev = F.pad(st[:, :-1], (1, 0), value=False)
    x1 = torch.where(st, xd, x_prev)
    x2 = torch.where(st, xd, torch.where(st_prev, x_prev, x_prev2))
    u = b0 * xd + b1 * x1 + b2 * x2
    # the map [[p, q], [r, s]] (y, carried y) + (v0, v1), one per frame
    zero, one = torch.zeros_like(xd), torch.ones_like(xd)
    p, q = torch.where(st, zero, -a1 * one), torch.where(st, zero, -a2 * one)
    r, s_ = torch.where(st, zero, one), zero
    v0, v1 = torch.where(st, u - (a1 + a2) * xd, u), torch.where(st, xd, zero)
    d = 1
    while d < g:  # frame t's map after frame t-d's: later @ earlier
        ep, eq, er, es, e0, e1 = (t[:, :-d] for t in (p, q, r, s_, v0, v1))
        lp, lq, lr, ls = (t[:, d:] for t in (p, q, r, s_))
        p, q, r, s_, v0, v1 = (torch.cat([t[:, :d], new], 1) for t, new in (
            (p, lp * ep + lq * er), (q, lp * eq + lq * es), (r, lr * ep + ls * er),
            (s_, lr * eq + ls * es), (v0, lp * e0 + lq * e1 + v0[:, d:]),
            (v1, lr * e0 + ls * e1 + v1[:, d:])))
        d *= 2
    return v0.to(x.dtype)


def _smooth_segments(f0: torch.Tensor) -> torch.Tensor:
    """Zero-phase 2nd-order Butterworth (fc = 0.03 of the 1 kHz grid) run
    forward then backward within each voiced segment, with edge-pad state
    (native zero_phase_lpf, dvc_world.cpp:284-307); segments shorter than 5
    frames pass through unchanged."""
    v = f0 > 0.0

    def starts(voiced):
        return voiced & ~F.pad(voiced[..., :-1], (1, 0), value=False)

    fwd = _iir_segments(f0, starts(v))
    vb = v.flip(-1)
    bwd = _iir_segments(fwd.flip(-1), starts(vb)).flip(-1)
    keep = (_run_lengths(v) < 5) | ~v
    return torch.where(keep, f0, bwd)


# ------------------------------------------------------------ the pass ---

def _harvest(wavs: torch.Tensor, lengths: torch.Tensor, fs: int, frame_period_ms: float,
             f0_floor: float, f0_ceil: float):
    plan = _plan(wavs.shape[-1], fs, f0_floor, f0_ceil)
    bsz = wavs.shape[0]
    dev = wavs.device

    # decimation, per-utterance mean removal, tail masking
    if plan.ratio > 1:
        fir = torch.from_numpy(plan.dec_fir.astype(np.float32)).to(dev)
        y = F.conv1d(wavs[:, None, :], fir[None, None, :], stride=plan.ratio,
                     padding=plan.dec_half)[:, 0, :plan.m]
    else:
        y = wavs[:, :plan.m]
    m_true = torch.clamp(lengths // plan.ratio, min=1)
    live = torch.arange(plan.m, device=dev)[None, :] < m_true[:, None]
    mean = torch.sum(torch.where(live, y, 0.0), dim=-1) / m_true.to(y.dtype)
    y = torch.where(live, y - mean[:, None], 0.0)

    # channel filtering and candidate contours, a block of channels at a time
    yf = torch.fft.rfft(y, n=plan.fft_size, dim=-1)  # (B, K)
    grid = torch.arange(plan.n1, dtype=torch.float32, device=dev) * _f32(CAND_PERIOD, y)
    bank = torch.from_numpy(plan.bank).to(dev)
    bf0s = torch.from_numpy(plan.bf0.astype(np.float32)).to(dev)
    cols = []
    for lo in range(0, bank.shape[0], plan.ch_block):
        filt = torch.fft.irfft(bank[lo:lo + plan.ch_block, None, :] * yf[None], n=plan.fft_size,
                               dim=-1)[..., :plan.m]
        cols.append(_channel_candidates(filt, bf0s[lo:lo + plan.ch_block], plan.afs, grid,
                                        plan.f0_floor, plan.f0_ceil))
    cols = torch.cat(cols)[:plan.n_ch]  # (C, B, G)

    # merge, refine, dedup, prune; the merge inserts at slot n_c, so used
    # slots are a dense prefix and truncating to _MAX_SLOTS keeps the
    # low-channel candidates (dvc_tpu/ops/harvest.py:784-792)
    cand, n_c = _merge_channels(cols, plan.n_ch)
    high_water = torch.max(n_c)
    cand = cand[..., :min(_MAX_SLOTS, cand.shape[-1])]
    y_pad = F.pad(y, (plan.max_half, plan.max_half))
    refined, score = _refine(plan, y_pad, cand)
    cand, score = _dedup_refined(refined, score)

    pad_frame = cand.new_zeros((bsz, 1, cand.shape[-1]))
    cprev = torch.cat([pad_frame, cand[:, :-1]], dim=1)
    cnext = torch.cat([cand[:, 1:], pad_frame], dim=1)
    fidx = torch.arange(plan.n1, device=dev)[None, :, None]
    rp = torch.where(fidx == 0, 0.0, _closest_ratio(cprev, cand))
    rn = torch.where(fidx == plan.n1 - 1, 0.0, _closest_ratio(cnext, cand))
    score = torch.where((cand > 0.0) & ((rp > 0.05) | (rn > 0.05)), 0.0, score)

    # base contour and the fix steps
    best, arg = torch.max(score, dim=-1)
    f0 = torch.where(best > 0.0, torch.gather(cand, -1, arg[..., None])[..., 0], 0.0)
    prev = F.pad(f0[:, :-1], (1, 0))
    jump = (f0 > 0.0) & (prev > 0.0) & ((f0 - prev).abs() / torch.clamp(f0, min=1e-12) > 0.008)
    step1 = torch.where(jump, 0.0, f0)
    step2 = torch.where(_run_lengths(step1 > 0.0) < 9, 0.0, step1)
    ext = _extend(step2, cand)
    ext = _extend(ext.flip(-1), cand.flip(-2)).flip(-1)
    final = _smooth_segments(ext)

    # the 1 ms track resampled to the frame period
    n_out = int(1000.0 * plan.n / fs / frame_period_ms) + 1
    t_out = np.arange(n_out) * frame_period_ms / 1000.0
    ki = torch.from_numpy(np.minimum(plan.n1 - 1, (t_out / CAND_PERIOD + 0.5).astype(np.int64)))
    out = final[:, ki.to(dev)]
    out = torch.where((out >= f0_floor) & (out <= f0_ceil), out, 0.0)
    # frames past each utterance's own end are unvoiced by contract
    n_true = (lengths.to(torch.float32) * _f32(1000.0 / fs / frame_period_ms, y)).to(
        torch.int32) + 1
    out = torch.where(torch.arange(n_out, device=dev)[None, :] < n_true[:, None], out, 0.0)
    return out, high_water


def harvest_batch(wavs, lengths=None, fs: int = 16_000, frame_period_ms: float = 5.0,
                  f0_floor: float = 71.0, f0_ceil: float = 800.0,
                  device: str | torch.device | None = None) -> torch.Tensor:
    """Batched Harvest F0 for (B, N) waveforms zero-padded to a shared N.

    lengths: the true sample counts (B,), N for every row by default.
    Returns f0 (B, n_out) float32 with n_out = int(1000 N / fs /
    frame_period) + 1; a row is unvoiced (0) past its own int(1000 len /
    fs / frame_period) + 1 frames (the native dvc_harvest / pyworld.harvest
    contract).  Runs on ``device``: wavs' own device for a tensor, cuda by
    default for an array."""
    if device is None and isinstance(wavs, torch.Tensor):
        dev = wavs.device
    else:
        dev = resolve_device(device or "cuda")
    if dev.type == "cuda":
        use_exact_float32()  # the decimation convolution is float32, never TF32
    wavs = torch.as_tensor(np.asarray(wavs, np.float32) if not isinstance(wavs, torch.Tensor)
                           else wavs).to(dev, torch.float32)
    if wavs.ndim == 1:
        wavs = wavs[None]
    if wavs.shape[-1] < 64:
        raise ValueError(f"harvest needs >= 64 samples, got {wavs.shape[-1]}")
    if not (f0_floor > 0.0 and f0_ceil > f0_floor and frame_period_ms > 0.0):
        raise ValueError("degenerate harvest parameters")
    if lengths is None:
        lengths = torch.full((wavs.shape[0],), wavs.shape[-1], dtype=torch.int64, device=dev)
    else:
        lengths = torch.as_tensor(np.asarray(lengths, np.int64)).to(dev)
    with torch.inference_mode():
        out, high_water = _harvest(wavs, lengths, int(fs), float(frame_period_ms),
                                   float(f0_floor), float(f0_ceil))
    # kept on the device: merge_slot_high_water() fetches it on demand
    _last_merge_slots[0] = high_water
    return out
