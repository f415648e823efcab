"""dvc_tpu's all-device WORLD chain in the port against dvc_tpu on the CPU:
the NCCF F0 tracker (estimate_f0), the correlation aperiodicity,
world_decompose(use_native=False), world_speech_synthesis(use_native=False),
the native DIO binding and the pitch helpers of ops/pitch.py.

Limits (measured in brackets):
  * estimate_f0: the same voicing on every frame, f0 within 1e-4 relative
    (5.7e-7), the time axis equal; the NCCF's float32 sums differ only in
    their order;
  * aperiodicity: within 1e-5 (6.3e-7);
  * world_decompose(use_native=False): f0 and ap as above, the mel-cepstrum
    within 1e-3 of its range (7.0e-6), as tests/test_torch_port_world_route.py holds
    the route, on its voices (a noise floor of 0.1, which CheapTrick's
    float32 sum in dvc_tpu needs);
  * world_speech_synthesis(use_native=False): dvc_tpu's noise drawn into the
    port's synthesis_noise, 1e-6 of the peak (1.1e-7), as
    tests/test_torch_port_world_synthesis.py holds synthesize;
  * dio: the same C++ source, equal; and tests/test_dio.py's truth gate
    (median relative error < 0.005 on a vibrato tone);
  * the pitch helpers: equal quantized bins on the voices (f0 4.5e-7
    relative apart with estimate_pitch's 50-2000 Hz band), and the one-hot
    exactly.  On a pure sine every multiple of the period correlates
    alike, so which lag wins is decided by the last bit of the NCCF's
    float32 sums; there the helpers are held to dvc_tpu's own contract
    (tests/test_misc_ops.py: integer bins in [0, 256], the frame count).
"""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.native import world as jnative
from dvc_tpu.ops import pitch as jpitch
from dvc_tpu.ops import world as jworld
from dvc_tpu_torch.native import world as pnative
from dvc_tpu_torch.ops import pitch as ppitch
from dvc_tpu_torch.ops import world as pworld
from test_dio import _harm
from test_torch_port_world_route import MC_RANGE_ATOL, _rel_range, voice
from test_torch_port_world_synthesis import SYNTH_RTOL, features, jax_draws, rel  # noqa: F401

SR = 16_000
F0_RTOL = 1e-4
AP_ATOL = 1e-5


def _check_f0(got, want):
    assert got.shape == want.shape and np.array_equal(got > 0, want > 0)
    v = want > 0
    assert v.sum() >= 30
    np.testing.assert_allclose(got[v], want[v], rtol=F0_RTOL)


@pytest.mark.parametrize("seed,f0c", [(1, 110.0), (2, 230.0)])
def test_estimate_f0(seed, f0c):
    x = voice(seed, 0.6, f0c)
    x[4000:5200] = 0.002 * np.random.RandomState(seed).randn(1200)  # an unvoiced stretch
    f0, ta = pworld.estimate_f0(torch.from_numpy(x), SR)
    jf0, jta = jworld.estimate_f0(jnp.asarray(x), SR)
    _check_f0(f0.numpy(), np.asarray(jf0))
    assert (f0.numpy() == 0).any()
    np.testing.assert_array_equal(ta.numpy(), np.asarray(jta))


def test_aperiodicity():
    x = voice(3, 0.5, 150.0)
    f0 = np.array(jworld.estimate_f0(jnp.asarray(x), SR)[0])
    f0[10:20] = 0
    got = pworld.aperiodicity(torch.from_numpy(x), torch.from_numpy(f0), SR).numpy()
    want = np.asarray(jworld.aperiodicity(jnp.asarray(x), jnp.asarray(f0), SR))
    assert got.shape == want.shape == (len(f0), 513)
    np.testing.assert_allclose(got, want, atol=AP_ATOL)
    assert np.all(got[10:20] == want[10:20])


def test_world_decompose_all_device_chain():
    x = voice(4, 0.7, 170.0)
    got = pworld.world_decompose(x, SR, use_native=False, device="cpu")
    want = jworld.world_decompose(x, SR, use_native=False)
    (f0, ta, sp, ap, mc), (jf0, jta, jsp, jap, jmc) = got, want
    assert all(g.shape == w.shape for g, w in zip(got, want)) and len(f0) == len(x) // 80 + 1
    _check_f0(f0, jf0)
    np.testing.assert_array_equal(ta, jta)
    np.testing.assert_allclose(ap, jap, atol=AP_ATOL)
    assert _rel_range(mc, jmc) <= MC_RANGE_ATOL
    # the default and True take the native engine, as dvc_tpu's production route
    for kw in ({}, {"use_native": True}):
        nat = pworld.world_decompose(x, SR, device="cpu", **kw)
        assert np.array_equal(nat[0], pnative.harvest(x, SR)[0][:len(nat[0])].astype(np.float32))


def test_world_speech_synthesis_on_the_device(jax_draws):  # noqa: F811
    f0, sp, ap = features(5, 80)
    want = jworld.world_speech_synthesis(f0, sp, ap, SR, use_native=False)
    got = pworld.world_speech_synthesis(f0, sp, ap, SR, use_native=False, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (80 * 80,)
    assert rel(got, want) <= SYNTH_RTOL
    native = pworld.world_speech_synthesis(f0, sp, ap, SR)
    assert np.array_equal(native, pworld.world_speech_synthesis(f0, sp, ap, SR, use_native=True))


def test_dio():
    x, _ = _harm(8000, lambda t: 180.0 * (1 + 0.04 * np.sin(2 * np.pi * 3 * t)))
    f0, ta = pnative.dio(x, SR)
    jf0, jta = jnative.dio(x, SR)
    assert np.array_equal(f0, jf0) and np.array_equal(ta, jta)
    v = f0 > 0
    assert v.mean() > 0.85
    truth = 180.0 * (1 + 0.04 * np.sin(2 * np.pi * 3 * ta))
    assert np.median(np.abs(f0[v] - truth[v]) / truth[v]) < 0.005
    with pytest.raises(RuntimeError, match="invalid dio"):
        pnative.dio(x, SR, f0_floor=800.0, f0_ceil=71.0)


def test_pitch_helpers():
    wavs = np.stack([voice(11, 0.5, 120.0), voice(12, 0.5, 200.0)])
    q = ppitch.estimate_pitch(torch.from_numpy(wavs[0])).numpy()
    assert np.array_equal(q, np.asarray(jpitch.estimate_pitch(jnp.asarray(wavs[0]))))
    got = ppitch.get_batch_pitch(torch.from_numpy(wavs)).numpy()
    assert got.shape == (2, 8000 // 80 + 1)
    assert np.array_equal(got, np.asarray(jpitch.get_batch_pitch(jnp.asarray(wavs))))
    sines = np.stack([0.4 * np.sin(2 * np.pi * f * np.arange(4000) / SR)
                      for f in (120.0, 180.0)]).astype(np.float32)
    q = ppitch.get_batch_pitch(torch.from_numpy(sines)).numpy()
    assert q.shape == (2, 4000 // 80 + 1)
    assert q.min() >= 0 and q.max() <= 256 and np.allclose(q, np.round(q))
    p = np.asarray([0.0, 128.0, 256.0, 400.0, -3.0], np.float32)
    oh = ppitch.quantized_pitch_onehot(torch.from_numpy(p), bins=257).numpy()
    assert oh.dtype == np.float32
    assert np.array_equal(oh, np.asarray(jpitch.quantized_pitch_onehot(jnp.asarray(p), 257)))
