"""The port's batched Harvest (dvc_tpu_torch/ops/harvest.py) against dvc_tpu's
(dvc_tpu/ops/harvest.py) and the native engine on the CPU.

All signals of tests/test_harvest_tpu.py go through both packages as one
batch at N = 8000 (one dvc_tpu compile for the file): a vibrato tone, low
and high pitch, white noise, voiced-silence-voiced, a tone against its true
contour, and a row masked to 5000 samples.  Limits (measured in brackets):
  * against dvc_tpu: voicing agreement >= 0.99 (1.0), and on frames voiced
    in both a median relative error <= 1e-5 (3.2e-6) and a 95th
    percentile <= 1e-4 (6.8e-5): float32 FFTs and sums in another order,
    and the smoother's float64 scan against dvc_tpu's float32 one;
  * against the native engine: test_harvest_tpu.py's gates per signal;
  * rows independent of their batch mates: the row alone at the limits
    against dvc_tpu (the CPU's decimation convolution rounds per batch
    shape, 4e-7 apart, which moves a few frames of the masked row by up to
    6.4e-4);
  * the merge's high-water mark within 10% of dvc_tpu's (54 against 50 on
    the noise row, where near-threshold candidates differ);
  * the grid reading (searchsorted and gathers) against dvc_tpu's lookback
    window: 1e-6 relative, also where event gaps outrun the window, where
    the searchsorted twin differs;
  * a 22.05 kHz input (a candidate grid of 11.025 samples: the twin and
    the refinement gather): the same limits as at 16 kHz (2.7e-6, 3.7e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.ops import harvest as jh
from dvc_tpu_torch.native import world as native_world
from dvc_tpu_torch.ops import harvest as ph

FS = 16_000
N = 8_000
AGREE_MIN = 0.99
MEDIAN_MAX = 1e-5
P95_MAX = 1e-4
GRID_RTOL = 1e-6


def _harm(n, f0_fn, amps=(0.6, 0.25, 0.1), noise=0.01, seed=0, fs=FS):
    r = np.random.RandomState(seed)
    t = np.arange(n) / fs
    ph_ = 2 * np.pi * np.cumsum(f0_fn(t)) / fs
    x = sum(a * np.sin((i + 1) * ph_ + i) for i, a in enumerate(amps))
    return (x + noise * r.randn(n)).astype(np.float32)


def _signals():
    vsv = np.concatenate([_harm(3000, lambda t: 150.0 + 0 * t, seed=4),
                          0.002 * np.random.RandomState(6).randn(2000).astype(np.float32),
                          _harm(3000, lambda t: 220.0 + 0 * t, seed=5)])
    return {
        "vibrato": (_harm(N, lambda t: 200.0 * (1 + 0.03 * np.sin(2 * np.pi * 3 * t))), N),
        "low": (_harm(N, lambda t: 85.0 * (1 + 0.02 * np.sin(2 * np.pi * 2 * t)), seed=1), N),
        "high": (_harm(N, lambda t: 600.0 * (1 + 0.02 * np.sin(2 * np.pi * 2 * t)),
                       amps=(0.7, 0.2), seed=3), N),
        "noise": (0.3 * np.random.RandomState(7).randn(N).astype(np.float32), N),
        "vsv": (vsv, N),
        "truth": (_harm(N, lambda t: 160.0 * (1 + 0.05 * np.sin(2 * np.pi * 2 * t))), N),
        "masked": (np.pad(_harm(5000, lambda t: 180.0 + 0 * t, seed=8), (0, N - 5000)), 5000),
    }


@pytest.fixture(scope="module")
def runs():
    """Both packages on the one batch; the port's high-water mark read
    right after its call."""
    sig = _signals()
    batch = np.stack([x for x, _ in sig.values()])
    lengths = [n for _, n in sig.values()]
    want = np.asarray(jh.harvest_batch(batch, lengths=lengths, fs=FS))
    j_hw = jh.merge_slot_high_water()
    got = ph.harvest_batch(torch.from_numpy(batch), lengths).numpy()
    return sig, batch, lengths, want, got, (j_hw, ph.merge_slot_high_water())


def _errs(a, b):
    va, vb = a > 0, b > 0
    both = va & vb
    err = np.abs(a[both] - b[both]) / b[both] if both.any() else np.zeros(0)
    return float((va == vb).mean()), err


def test_against_dvc_tpu(runs):
    sig, _, _, want, got, _ = runs
    assert got.dtype == np.float32 and got.shape == want.shape == (len(sig), 101)
    for name, g, w in zip(sig, got, want):
        agree, err = _errs(g, w)
        assert agree >= AGREE_MIN, name
        if name != "noise":
            assert err.size >= 30, name
            assert np.median(err) <= MEDIAN_MAX and np.percentile(err, 95) <= P95_MAX, name


def _native(x, n_true, **kw):
    f0n, _ = native_world.harvest(x[:n_true], FS, 5.0, **kw)
    return f0n


def test_against_native(runs):
    """test_harvest_tpu.py's gates (tests/test_harvest_tpu.py:48-138)."""
    sig, _, _, _, got, _ = runs
    out = dict(zip(sig, got))
    res = {}
    for name, (x, n) in sig.items():
        f0n = _native(x, n)
        res[name] = _errs(out[name][:len(f0n)], f0n)
    agree, err = res["vibrato"]
    assert agree >= 0.97 and err.size >= 50
    assert np.median(err) < 0.005 and np.percentile(err, 95) < 0.02
    for name in ("low", "high"):
        agree, err = res[name]
        assert agree >= 0.95 and err.size and np.median(err) < 0.005, name
    assert float((out["noise"] > 0).mean()) < 0.05 and res["noise"][0] >= 0.95
    agree, err = res["vsv"]
    assert agree >= 0.93 and err.size and np.median(err) < 0.01
    tt = np.arange(len(out["truth"])) * 0.005
    truth = 160.0 * (1 + 0.05 * np.sin(2 * np.pi * 2 * tt))
    v = out["truth"] > 0
    assert v.mean() > 0.8 and np.median(np.abs(out["truth"][v] - truth[v]) / truth[v]) < 0.01
    n_true = int(1000.0 * 5000 / FS / 5.0) + 1
    assert np.all(out["masked"][n_true:] == 0.0) and (out["masked"][:n_true] > 0).mean() > 0.8


def test_rows_independent(runs):
    sig, batch, lengths, _, got, _ = runs
    for i in (0, 4, 6):
        alone = ph.harvest_batch(torch.from_numpy(batch[i:i + 1]), lengths[i:i + 1]).numpy()[0]
        agree, err = _errs(alone, got[i])
        assert agree >= AGREE_MIN and err.size >= 30, i
        assert np.median(err) <= MEDIAN_MAX and np.percentile(err, 95) <= P95_MAX, i


def test_merge_slot_high_water(runs):
    """The high-water mark is near dvc_tpu's on the same batch, and
    DVC_HARVEST_MAX_SLOTS (32) bounds the slots kept in both."""
    *_, (j_hw, p_hw) = runs
    assert p_hw >= 1 and abs(p_hw - j_hw) <= 0.1 * j_hw
    assert ph._MAX_SLOTS == jh._MAX_SLOTS == 32


def test_parameter_validation():
    with pytest.raises(ValueError):
        ph.harvest_batch(np.zeros(32, np.float32), fs=FS, device="cpu")
    with pytest.raises(ValueError):
        ph.harvest_batch(np.zeros((1, N), np.float32), fs=FS, f0_floor=800.0, f0_ceil=71.0,
                         device="cpu")


def _grid_inputs(gaps: bool):
    """Crossing trains of band-limited noise rows; with ``gaps``, each row
    silent over spans longer than the lookback (event gaps of 400-900
    samples)."""
    rng = np.random.RandomState(0)
    afs, stride, e = 8000.0, 8, 4000
    rows = []
    for r in range(6):
        x = rng.randn(e + 1)
        for _ in range(3):
            x = np.convolve(x, np.ones(9) / 9.0, mode="same")
        if gaps:
            for start in (500 + 90 * r, 2200 + 150 * r):
                x[start:start + 400 + 100 * r] = 1e-3
        rows.append(x[:e + 1])
    s = np.stack(rows).astype(np.float32)
    a, b = s[:, :-1], s[:, 1:]
    cross = (a > 0) & (b <= 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        loc = ((np.arange(e, dtype=np.float32) + a / np.where(a == b, 1.0, a - b))
               / np.float32(afs)).astype(np.float32)
    grid = (np.arange(e // stride + 1, dtype=np.float32) * np.float32(stride / afs))
    return cross, loc, grid, stride


@pytest.mark.parametrize("gaps", [False, True])
def test_grid_eval_keeps_the_lookback(gaps):
    """The port's searchsorted reading equals dvc_tpu's lookback-window
    reading; where gaps outrun the window the searchsorted twin differs
    (so the bound's result is what is kept)."""
    cross, loc, grid, stride = _grid_inputs(gaps)
    jtm, jfv = jh._track_fields(jnp.asarray(cross), jnp.asarray(loc))
    want = np.asarray(jh._grid_eval_uniform(jtm, jfv, stride, jnp.asarray(grid)))
    tm, fv = ph._track_fields(torch.from_numpy(cross), torch.from_numpy(loc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jtm))
    got = ph._grid_eval_uniform(tm, fv, stride, torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, rtol=GRID_RTOL, atol=0)
    assert (got > 0).mean() > 0.5
    ev, tm_o, fv_o = ph._interval_track(torch.from_numpy(cross), torch.from_numpy(loc))
    twin = ph._interp_track_grid(ev, tm_o, fv_o, torch.from_numpy(grid)).numpy()
    differs = np.abs(twin - got) > 1e-3 * np.abs(got).max()
    assert differs.any() == gaps


def test_22050_hz_against_dvc_tpu():
    """At 22.05 kHz (analysis rate 11025 Hz) the candidate grid falls between
    samples: the searchsorted twin and the refinement gather run."""
    fs, n = 22_050, 11_025
    x = _harm(n, lambda t: 180.0 * (1 + 0.03 * np.sin(2 * np.pi * 3 * t)), seed=9, fs=fs)
    want = np.asarray(jh.harvest_batch(x[None], fs=fs))[0]
    got = ph.harvest_batch(torch.from_numpy(x[None]), fs=fs).numpy()[0]
    agree, err = _errs(got, want)
    assert got.shape == want.shape and agree >= AGREE_MIN and err.size >= 50
    assert np.median(err) <= MEDIAN_MAX and np.percentile(err, 95) <= P95_MAX
