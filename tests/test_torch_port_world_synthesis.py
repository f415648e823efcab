"""The WORLD synthesis of the port against dvc_tpu on the CPU: mc2sp and
world_decode_mc, the pulse phase's prefix sum, the minimum-phase
responses, synthesize and synthesize_batch, the native synthesizer, and
the statistics and pitch conversion.

dvc_tpu draws the synthesis noise with jax.random under fold_in(PRNGKey(
seed), i) (PRNGKey(seed) for synthesize); the tests put those draws into
the port's ``synthesis_noise``, so both synthesize from the same noise.
The pulse phase is a float32 prefix sum; the port adds in XLA's order
(``xla_cumsum``), so the pulses fall on the same samples and the waveforms
differ only by the FFTs' and the overlap-add's float32 rounding.

Limits (measured in brackets):
  * mc2sp and world_decode_mc: 1e-5 in log power against dvc_tpu (2.9e-6)
    and against a float64 evaluation of the same formula (2.8e-6; dvc_tpu's
    float32 recursion to order 512 is 2.6e-6 off it);
  * xla_cumsum: equal to jnp.cumsum bit for bit;
  * the minimum-phase responses: 1e-6 of their max (7.9e-8);
  * synthesize and synthesize_batch: 1e-6 of the peak (1.1e-7, 1.5e-7);
  * the native synthesizer, the same C++ source: 1e-6 of the peak (0.0);
  * the statistics and the pitch conversion: equal.
"""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.native import world as jnative
from dvc_tpu.ops import world as jworld
from dvc_tpu_torch.native import world as pnative
from dvc_tpu_torch.ops import world as pworld

SR = 16_000
FFT = jworld.cheaptrick_fft_size(SR)
ALPHA = jworld.mcepalpha(SR)
LOG_ATOL = 1e-5
IR_RTOL = 1e-6
SYNTH_RTOL = 1e-6
NATIVE_RTOL = 1e-6


def jax_noise(seed, index, n):
    key = jax.random.PRNGKey(seed)
    if index is not None:
        key = jax.random.fold_in(key, index)
    return torch.from_numpy(np.array(jax.random.normal(key, (n,))))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(pworld, "synthesis_noise", jax_noise)


def mcep_track(seed, n):
    """(n, 36) mel-cepstra of a speech-like envelope: c0 near -3, the rest
    decaying with the index."""
    r = np.random.RandomState(seed)
    mc = r.randn(n, 36) * (0.6 / (1.0 + np.arange(36)))
    mc[:, 0] -= 3.0
    return mc.astype(np.float32)


def features(seed, n):
    """(f0, sp, ap) of n frames: a moving f0 with an unvoiced stretch, the
    envelope of mcep_track, and the flat conversion aperiodicity."""
    f0 = (120 + 40 * np.sin(np.arange(n) / 15.0 + seed)).astype(np.float32)
    f0[n // 3:n // 2] = 0
    sp = np.asarray(jworld.mc2sp(jnp.asarray(mcep_track(seed, n)), ALPHA, FFT))
    ap = np.full(sp.shape, 0.2, np.float32)
    ap[f0 == 0] = 1 - 1e-12
    return f0, sp, ap


def rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def mc2sp_f64(mc, alpha, fftlen):
    """log of pysptk's mc2sp, the formula of dvc_tpu's evaluated in float64."""
    c = mc.astype(np.float64) @ pworld.freqt_matrix(mc.shape[-1], fftlen // 2, -alpha)
    c[..., 0] *= 2.0
    return np.fft.rfft(np.concatenate([c, c[..., -2:0:-1]], -1), axis=-1).real


def test_mc2sp_and_world_decode_mc():
    mc = mcep_track(0, 60)
    want = np.log(np.asarray(jworld.mc2sp(jnp.asarray(mc), ALPHA, FFT)))
    got = np.log(pworld.mc2sp(torch.from_numpy(mc), ALPHA, FFT).numpy())
    assert got.shape == want.shape == (60, FFT // 2 + 1)
    assert np.abs(got - want).max() <= LOG_ATOL
    assert np.abs(got - mc2sp_f64(mc, ALPHA, FFT)).max() <= LOG_ATOL
    dec = pworld.world_decode_mc(mc.astype(np.float64), SR, device="cpu")
    assert dec.dtype == np.float32
    assert np.abs(np.log(dec) - np.log(jworld.world_decode_mc(mc, SR))).max() <= LOG_ATOL


@pytest.mark.parametrize("shape", [(5,), (16,), (3, 17), (2, 4000), (1, 20480)])
def test_xla_cumsum_is_jnp_cumsum(shape):
    x = (np.random.RandomState(sum(shape)).rand(*shape) * 0.03).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(pworld.xla_cumsum(torch.from_numpy(x)).numpy(), want)


def test_minimum_phase_ir():
    _, sp, _ = features(1, 40)
    want = np.asarray(jworld._minimum_phase_ir(jnp.asarray(sp), FFT))
    got = pworld._minimum_phase_ir(torch.from_numpy(sp), FFT).numpy()
    assert got.shape == want.shape == (40, FFT)
    assert rel(got, want) <= IR_RTOL


def test_synthesize_with_jax_noise(jax_draws):
    f0, sp, ap = features(2, 90)
    want = np.asarray(jworld.synthesize(jnp.asarray(f0), jnp.asarray(sp), jnp.asarray(ap),
                                        SR, seed=3))
    got = pworld.synthesize(torch.from_numpy(f0), torch.from_numpy(sp), torch.from_numpy(ap),
                            SR, seed=3).numpy()
    assert got.shape == want.shape == (90 * 80,)
    assert rel(got, want) <= SYNTH_RTOL


def test_synthesize_batch_with_jax_noise(jax_draws):
    """Three utterances over two length buckets against dvc_tpu's; chunking a
    bucket (max_batch=1) changes no row, since the noise is keyed by the
    list index; the argument checks are dvc_tpu's."""
    feats = [features(s, n) for s, n in ((3, 130), (4, 200), (5, 300))]
    args = [[f[k] for f in feats] for k in range(3)]
    want = jworld.synthesize_batch(*args, SR, seed=7)
    got = pworld.synthesize_batch(*args, SR, seed=7, device="cpu")
    for g, w, (f0, _, _) in zip(got, want, feats):
        assert g.dtype == np.float32 and g.shape == w.shape == (len(f0) * 80,)
        assert rel(g, w) <= SYNTH_RTOL
    alone = pworld.synthesize_batch(*args, SR, seed=7, max_batch=1, device="cpu")
    for a, g in zip(alone, got):
        np.testing.assert_allclose(a, g, rtol=0, atol=1e-6 * np.abs(g).max())
    assert pworld.synthesize_batch([], [], [], device="cpu") == []
    with pytest.raises(ValueError, match="same length"):
        pworld.synthesize_batch(args[0], args[1][:1], args[2], device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        pworld.synthesize_batch(args[0][:1], [args[1][0][:-1]], args[2][:1], device="cpu")


def test_synthesis_noise_is_keyed():
    a, b = pworld.synthesis_noise(0, 1, 800), pworld.synthesis_noise(0, 1, 800)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, pworld.synthesis_noise(0, 2, 800))
    assert not torch.equal(a, pworld.synthesis_noise(1, 1, 800))
    assert not torch.equal(pworld.synthesis_noise(0, None, 800), pworld.synthesis_noise(0, 0, 800))


def test_native_synthesis_and_world_speech_synthesis():
    f0, sp, ap = features(6, 150)
    want = jnative.synthesize(f0, sp, ap, SR, 5.0, seed=2)
    got = pnative.synthesize(f0, sp, ap, SR, 5.0, seed=2)
    assert got.dtype == np.float32 and got.shape == want.shape == (150 * 80,)
    assert rel(got, want) <= NATIVE_RTOL
    w = jworld.world_speech_synthesis(f0, sp, ap, SR)
    g = pworld.world_speech_synthesis(f0, sp, ap, SR)
    assert g.shape == w.shape == (150 * 80,) and rel(g, w) <= NATIVE_RTOL
    with pytest.raises(ValueError, match="shape mismatch"):
        pnative.synthesize(f0[:-1], sp, ap, SR)


def test_statistics_and_pitch_conversion():
    r = np.random.RandomState(9)
    mcs = r.randn(36, 300)
    for a, b in zip(pworld.mcs_normalization_fit_transform(mcs),
                    jworld.mcs_normalization_fit_transform(mcs)):
        np.testing.assert_array_equal(a, b)
    f0 = np.where(r.rand(300) > 0.3, r.uniform(90, 250, 300), 0.0)
    assert pworld.logf0_statistics(f0) == jworld.logf0_statistics(f0)
    v = f0[f0 > 0]
    np.testing.assert_array_equal(pworld.pitch_conversion(v, 4.8, 0.2, 5.1, 0.15),
                                  jworld.pitch_conversion(v, 4.8, 0.2, 5.1, 0.15))
