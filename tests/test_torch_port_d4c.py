"""The port's device D4C (dvc_tpu_torch/ops/d4c.py) against dvc_tpu's
(dvc_tpu/ops/d4c.py) and the native engine on the CPU, on the vowels of
tests/test_d4c_tpu.py, and world_decompose_batch(keep_sp_ap=True).

Both device D4Cs run in float32, and their group delay, centroid over
smoothed power, divides by the power spectrum's valleys, where two FFT
implementations (XLA's and PyTorch's) differ in the last bits: on the
realistic vowel dvc_tpu's float32 D4C is 1.5e-3 from the float64 native
engine and the port's 7.5e-4, and the two float32 results are 1.7e-3
apart (5e-3 on the clean vowel, whose valleys reach the FFT's noise
floor).  So the port is held

  * in float64, to the native engine, the same algorithm in float64:
    NATIVE64_ATOL on the realistic vowel, through the per-utterance body
    and through d4c_batch on a padded batch of three vowels (measured
    3.4e-6 on the realistic vowel);
  * in float32, to dvc_tpu's D4C and to the native engine at the gates
    tests/test_d4c_tpu.py holds dvc_tpu's float32 D4C to: clean vowel mean
    < 0.02 and max < 0.08, realistic vowel max < 0.01;
  * to itself at test_d4c_tpu.py:121's 2e-4 across padding, and padded
    rows and unvoiced frames to 1.0 within 1e-6.
"""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import numpy as np
import pytest
import torch

from dvc_tpu.native import world as jnative
from dvc_tpu.ops import world as jworld
from dvc_tpu.ops.d4c import d4c_batch as jax_d4c_batch
from dvc_tpu_torch.ops import d4c as pd4c
from dvc_tpu_torch.ops import world as pworld
from test_d4c_tpu import FS, _vowel
from test_torch_port_world_route import (AGREE_MIN, F0_MEDIAN_MAX, MC_RANGE_ATOL, _rel_range,
                                         voice)

NATIVE64_ATOL = 1e-4
PAD_ATOL = 2e-4
ONE_ATOL = 1e-6


def _port(w, f0, **kw):
    return pd4c.d4c_batch(w[None], np.asarray(f0, np.float32)[None], FS, device="cpu",
                          **kw).numpy()[0]


@pytest.fixture(scope="module", params=["clean", "realistic"])
def vowel(request):
    kw = {} if request.param == "clean" else dict(vibrato=0.03, noise_db=-50.0, seed=1)
    w = _vowel(**kw)
    f0, _ = jnative.harvest(w, FS)
    return request.param, w, f0, jnative.d4c(w, f0, FS)


def test_d4c_batch_against_dvc_tpu_and_native(vowel):
    name, w, f0, native = vowel
    got = _port(w, f0)
    want = np.asarray(jax_d4c_batch(w[None], f0.astype(np.float32)[None], FS))[0]
    assert got.shape == want.shape == native.shape and got.dtype == np.float32
    voiced = f0 > 0
    assert voiced.sum() > 50
    # the cross-FFT gates, measured on this host: clean against dvc_tpu mean
    # 9.1e-4, max 4.8e-3, against native mean 1.8e-3, max 1.4e-2; realistic
    # max 1.7e-3 against dvc_tpu and 7.5e-4 against native
    for ref in (want, native):
        d = np.abs(got - ref)[voiced]
        if name == "clean":
            assert d.mean() < 0.02 and d.max() < 0.08, (d.mean(), d.max())
        else:
            assert d.max() < 0.01, d.max()
    unvoiced = f0 == 0
    assert unvoiced.any() and np.allclose(got[unvoiced], 1.0, atol=ONE_ATOL)


def test_float64_body_is_the_native_algorithm():
    """The per-utterance body in float64 is native dvc_d4c's computation."""
    w = _vowel(vibrato=0.03, noise_db=-50.0, seed=1)
    f0, _ = jnative.harvest(w, FS)
    native = jnative.d4c(w, f0, FS)
    got = pd4c._one_utterance(pd4c._plan(FS, 1024), 5.0, 0.85,
                              torch.from_numpy(w).double()[None],
                              torch.from_numpy(f0)[None])[0].numpy()
    assert np.abs(got - native)[f0 > 0].max() <= NATIVE64_ATOL


def test_d4c_batch_float64_padded_is_the_native_algorithm():
    """d4c_batch itself, in float64 on a zero-padded batch of three vowels
    of different lengths and pitches (its masks, padding, static-shape
    gathers and passes), against native dvc_d4c on each vowel alone:
    NATIVE64_ATOL on every frame, padded frames 1.0 within 1e-6."""
    ws = [_vowel(vibrato=0.03, noise_db=-50.0, seed=1),
          _vowel(seconds=0.8, f0=130.0, noise_db=-45.0, seed=5),
          _vowel(seconds=1.1, f0=220.0, noise_db=-45.0, seed=6)]
    f0s = [jnative.harvest(w, FS)[0] for w in ws]
    n, nf = max(map(len, ws)), max(map(len, f0s))
    wav_b, f0_b = np.zeros((3, n)), np.zeros((3, nf))
    for i, (w, f0) in enumerate(zip(ws, f0s)):
        wav_b[i, :len(w)], f0_b[i, :len(f0)] = w, f0
    ap_b = pd4c.d4c_batch(wav_b, f0_b, FS, device="cpu", dtype=torch.float64).numpy()
    assert ap_b.dtype == np.float64 and ap_b.shape == (3, nf, 513)
    for i, (w, f0) in enumerate(zip(ws, f0s)):
        native = jnative.d4c(w, f0, FS)
        assert (f0 > 0).sum() > 50
        assert np.abs(ap_b[i, :len(f0)] - native).max() <= NATIVE64_ATOL, i
        assert np.allclose(ap_b[i, len(f0):], 1.0, atol=ONE_ATOL)


def test_padding_and_batch_contract():
    """A zero-padded row equals the utterance alone within 2e-4, its
    padded frames are 1.0; shapes, range and the batch check."""
    w1 = _vowel(seconds=0.8, f0=130.0, noise_db=-45.0, seed=5)
    w2 = _vowel(seconds=1.1, f0=220.0, noise_db=-45.0, seed=6)
    f01, _ = jnative.harvest(w1, FS)
    f02, _ = jnative.harvest(w2, FS)
    wav_b = np.zeros((2, len(w2)), np.float32)
    wav_b[0, :len(w1)], wav_b[1] = w1, w2
    f0_b = np.zeros((2, len(f02)), np.float32)
    f0_b[0, :len(f01)], f0_b[1] = f01, f02
    ap_b = pd4c.d4c_batch(wav_b, f0_b, FS, device="cpu").numpy()
    solo = _port(w1, f01)
    np.testing.assert_allclose(ap_b[0, :len(f01)], solo, atol=PAD_ATOL)
    assert np.allclose(ap_b[0, len(f01):], 1.0, atol=ONE_ATOL)
    assert ap_b.shape == (2, len(f02), 513)
    assert (ap_b >= 0.001).all() and (ap_b < 1.0).all() and np.isfinite(ap_b).all()
    with pytest.raises(ValueError, match="batch mismatch"):
        pd4c.d4c_batch(np.zeros((2, 1000), np.float32), np.zeros((3, 10), np.float32), FS,
                       device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pd4c.d4c_batch(wav_b, f0_b, FS)


def test_love_train_override_and_threshold():
    """A high-band noise burst with a made-up voiced track is forced fully
    aperiodic, as natively; threshold 0 turns the override off."""
    rng = np.random.RandomState(3)
    w = (0.5 * rng.randn(FS)).astype(np.float32)
    spec = np.fft.rfft(w)
    spec[np.fft.rfftfreq(len(w), 1 / FS) < 5000] = 0
    hp = np.fft.irfft(spec, len(w)).astype(np.float32)
    hp /= np.abs(hp).max()
    f0 = np.full(201, 150.0)
    assert np.allclose(jnative.d4c(hp, f0, FS), 1.0, atol=ONE_ATOL)
    assert np.allclose(_port(hp, f0), 1.0, atol=ONE_ATOL)
    w /= np.abs(w).max()
    assert not np.allclose(_port(w, f0, threshold=0.0), 1.0, atol=1e-3)


def test_world_decompose_batch_keeps_sp_ap():
    """sp, ap and mc of world_decompose_batch(keep_sp_ap=True) against
    dvc_tpu's on tests/test_torch_port_world_route.py's voices (a noise
    floor of 0.1, which CheapTrick's float32 sum in dvc_tpu needs): f0 and
    mc at that file's limits (voicing agreement >= 0.99, median relative
    f0 error <= 1e-5, mc within 1e-3 of its range), the log of sp within
    1e-2 of its range (3.0e-3: CheapTrick's window moves with f0 by whole
    samples, as for the mc) and ap at the realistic vowel's D4C gate, 0.01
    (1.0e-4 with eight torch threads, 1.0e-3 with one: the sums' order
    moves the group delay's valleys)."""
    wavs = [voice(7, 0.7, 140.0), voice(8, 1.0, 210.0)]
    want = jworld.world_decompose_batch(wavs, FS, keep_sp_ap=True)
    got = pworld.world_decompose_batch(wavs, FS, keep_sp_ap=True, device="cpu")
    for (gf, gt, gsp, gap, gmc), (wf, wt, wsp, wap, wmc) in zip(got, want):
        assert gsp.shape == wsp.shape and gap.shape == wap.shape and gmc.shape == wmc.shape
        assert gap.dtype == np.float32 and np.array_equal(gt, wt)
        both = (gf > 0) & (wf > 0)
        assert ((gf > 0) == (wf > 0)).mean() >= AGREE_MIN and both.sum() >= 30
        assert np.median(np.abs(gf[both] - wf[both]) / wf[both]) <= F0_MEDIAN_MAX
        assert _rel_range(gmc, wmc) <= MC_RANGE_ATOL
        assert _rel_range(np.log(gsp), np.log(wsp)) <= 1e-2
        assert np.abs(gap - wap).max() < 0.01
    none = pworld.world_decompose_batch(wavs[:1], FS, keep_sp_ap=False, device="cpu")[0]
    assert none[2] is None and none[3] is None
