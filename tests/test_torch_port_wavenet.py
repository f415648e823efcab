"""Port parity of the WaveNet vocoder at the TINY config of
tests/test_pallas_wavenet.py: the upsampler, the teacher-forced logits, the
kernel's packing and plain sampler against dvc_tpu's interpret-mode Pallas
kernel and lax.scan sampler, and the MoL sampler's distribution.

Sampling is made deterministic by the doctored head of
tests/test_pallas_wavenet.py:26-44 (mixture 0 dominates, log scales pinned
at -40), so trajectories compare value for value whatever the RNG.  Mixture
0's mean row is centred and scaled (``_moving``, as chip_smoke.doctor_head
does) so that the trajectory moves inside (-1, 1): the raw doctored head
pins it near the -1 clip, where a wrong weight changes no sample."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dvc_tpu.config import VocoderConfig as JaxVocoderConfig
from dvc_tpu.kernels import wavenet_step as jstep
from dvc_tpu.models import wavenet as jwn
from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.convert.vocode import make_vocoder
from dvc_tpu_torch.kernels import wavenet_step as step
from dvc_tpu_torch.models import wavenet as wn
from dvc_tpu_torch.utils.convert import fuse_weight_norm, wavenet_state_dict_from_jax

TINY_KW = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16,
               skip_out_channels=8, cin_channels=4, upsample_scales=(2, 2),
               out_channels=6)
JTINY = JaxVocoderConfig(**TINY_KW)
TINY = VocoderConfig(**TINY_KW)
TOL = 2e-4  # the AR sampler gate of tests/test_pallas_wavenet.py:58
TRAJ_STD = 0.05  # trajectory spread required: the raw doctored head gives 0.008-0.016
                 # at these shapes (pinned at the clip), the centred one 0.20-0.32


def _doctored(params, cfg):
    params = jax.tree_util.tree_map(np.array, params)
    nr_mix = cfg.out_channels // 3
    k, b = params["final2"]["kernel"], params["final2"]["bias"]
    k[..., :nr_mix] = 0.0
    k[..., 2 * nr_mix:] = 0.0
    b[:nr_mix] = -10.0
    b[0] = 10.0
    b[2 * nr_mix:] = -40.0
    k[..., nr_mix:2 * nr_mix] *= 20.0
    return params


def _jax_params(seed, doctor=True):
    hop = int(np.prod(JTINY.upsample_scales))
    v = jwn.WaveNet(JTINY).init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 3 * hop, 1)), jnp.ones((1, 3, 4)))
    params = jax.tree_util.tree_map(np.array, jax.device_get(v["params"]))
    # non-zero upsampler biases exercise the bias path of the transposed convs
    for j in range(len(JTINY.upsample_scales)):
        params["upsample"][f"up{j}_bias"] = np.array([0.05 * (j + 1)], np.float32)
    return _doctored(params, JTINY) if doctor else params


def _port(params):
    m = wn.WaveNet(TINY).eval()
    m.load_state_dict(wavenet_state_dict_from_jax(params))  # strict
    return m


def _moving(params):
    """The doctored head with mixture 0's mean row centred and scaled, as
    chip_smoke.doctor_head does: over a teacher-forced pass of random frames
    it has mean 0 and std 0.05, so the trajectory moves inside (-1, 1)
    instead of resting on the clip, where a wrong weight can hide."""
    nr = TINY.out_channels // 3
    frames = torch.from_numpy(np.random.RandomState(99).rand(2, 16, TINY.cin_channels)
                              .astype(np.float32))
    m = _port(params)
    with torch.no_grad():
        mean0 = m(torch.zeros(2, 16 * m.hop, 1), frames)[..., nr].numpy()
    mean0 = mean0 - params["final2"]["bias"][nr]
    k = np.float32(0.05 / mean0.std())
    params["final2"]["kernel"][..., nr] *= k
    params["final2"]["bias"][nr] = -k * mean0.mean()
    return params


def _moves(traj):
    """The trajectory is off the clip and spread: a saturated head fails."""
    return traj.std() > TRAJ_STD and np.abs(traj).max() < 1.0


@pytest.fixture(scope="module")
def det():
    params = _moving(_jax_params(0))
    return params, _port(params)


def test_upsample_and_teacher_forced(det):
    params, m = det
    rng = np.random.RandomState(0)
    c = rng.rand(2, 5, 4).astype(np.float32)
    up = fnn.apply(lambda mod, x: mod.upsample(x), jwn.WaveNet(JTINY))
    want = np.asarray(up({"params": params}, jnp.asarray(c)))
    with torch.no_grad():
        got = m.upsample(torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (2, 20, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    x = rng.uniform(-1, 1, (2, 20, 1)).astype(np.float32)
    want = np.asarray(jwn.WaveNet(JTINY).apply({"params": _jax_params(1, False)},
                                               jnp.asarray(x), jnp.asarray(c)))
    with torch.no_grad():
        got = _port(_jax_params(1, False))(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (2, 20, 6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_packing_matches_pallas_layout(det):
    """The output-major pack holds the same numbers as dvc_tpu's (in, out)
    pack, and the same ring geometry."""
    params, m = det
    want = jstep.pack_wavenet_params(params, JTINY, jnp.float32)
    got = step.pack_wavenet_params(m, torch.float32, "cpu")
    R, C = TINY.residual_channels, TINY.cin_channels
    w_in = got["w_in"].numpy()
    assert w_in.shape[2] % 8 == 0 and not w_in[:, :, 3 * R + C:].any()
    for tap in range(3):
        np.testing.assert_array_equal(w_in[:, :, tap * R:(tap + 1) * R],
                                      np.asarray(want["w_dil"][:, tap]).transpose(0, 2, 1))
    np.testing.assert_array_equal(w_in[:, :, 3 * R:3 * R + C],
                                  np.asarray(want["w_c"]).transpose(0, 2, 1))
    S = TINY.skip_out_channels
    np.testing.assert_array_equal(got["w_so"][:, :S].numpy(),
                                  np.asarray(want["w_skip"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(got["w_so"][:, S:].numpy(),
                                  np.asarray(want["w_out"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(got["dil"], np.asarray(want["dil"]))
    np.testing.assert_array_equal(got["offs"], np.asarray(want["offs"]))
    assert got["slots"] == want["buf_total"]
    full = VocoderConfig()
    assert sum(2 * full.dilation(i) for i in range(full.layers)) == 504


def _cond(m, c):
    with torch.no_grad():
        return m.upsample(torch.from_numpy(c)).contiguous()


@pytest.mark.parametrize("dtype,atol", [("float32", TOL), ("bfloat16", 0.15)])
def test_plain_sampler_matches_pallas_interpret(det, dtype, atol):
    """wavenet_generate on CPU (the kernel's plain version) vs the TPU
    kernel in interpret mode; bf16 weights: atol 0.15, the protocol of
    tests/test_pallas_wavenet.py:131-142."""
    params, m = det
    c = np.random.RandomState(0).rand(2, 3, 4).astype(np.float32)
    want = np.asarray(jstep.pallas_generate({"params": params}, jnp.asarray(c), seed=123,
                                            cfg=JTINY, interpret=True,
                                            weight_dtype=getattr(jnp, dtype),
                                            deterministic=True))
    packed = step.pack_wavenet_params(m, getattr(torch, dtype), "cpu")
    got = step.wavenet_generate(packed, _cond(m, c), seed=123, deterministic=True).numpy()
    assert got.shape == want.shape == (2, 12)
    assert _moves(want)
    np.testing.assert_allclose(got, want, rtol=0 if atol > TOL else TOL, atol=atol)


def test_plain_samplers_match_scan(det):
    """The kernel's plain version (mod-2d ring; deterministic mode, and the
    stochastic path through the doctored head) against dvc_tpu's lax.scan
    fast_generate (ring shifted by one slot per sample)."""
    params, m = det
    c = np.random.RandomState(1).rand(2, 5, 4).astype(np.float32)
    want = np.asarray(jwn.fast_generate({"params": params}, jnp.asarray(c),
                                        jax.random.PRNGKey(7), JTINY))
    assert _moves(want)
    packed = step.pack_wavenet_params(m, torch.float32, "cpu")
    for det_mode in (True, False):
        got = step.wavenet_generate(packed, _cond(m, c), seed=4, deterministic=det_mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_sample_from_mol_moments():
    """One fixed y_hat, 40k draws each: mixture frequencies within 0.02 of
    softmax(logits), and sample mean and std within 0.02 of dvc_tpu's."""
    logits = np.array([0.3, -0.5, 1.0, 0.0], np.float32)
    means = np.array([-0.75, -0.25, 0.25, 0.75], np.float32)
    y = np.concatenate([logits, means, np.full(4, -6.0, np.float32)])
    n = 40_000
    ys = np.broadcast_to(y, (n, 12))
    want = np.asarray(jwn.sample_from_mol(jnp.asarray(ys), jax.random.PRNGKey(0)))
    got = wn.sample_from_mol(torch.from_numpy(ys.copy()), torch.Generator().manual_seed(0))
    got = got.numpy()
    got_k = step.mol_sample(torch.from_numpy(ys.copy()), seed=0).numpy()  # CPU wrapper
    soft = np.exp(logits) / np.exp(logits).sum()
    for draws in (got, got_k, want):
        nearest = np.abs(draws[:, None] - means[None]).argmin(1)
        freq = np.bincount(nearest, minlength=4) / n
        np.testing.assert_allclose(freq, soft, atol=0.02)
        assert np.abs(draws).max() <= 1.0
    for draws in (got, got_k):
        assert abs(draws.mean() - want.mean()) < 0.02
        assert abs(draws.std() - want.std()) < 0.02


def test_mol_deterministic_is_argmax_mean():
    y = torch.tensor([[0.1, 2.0, -1.0, 0.3, 1.7, -0.2, -3.0, -3.0, -3.0]])
    assert step.mol_sample(y, deterministic=True).item() == pytest.approx(1.0)  # clipped
    y[0, 1] = -5.0
    assert step.mol_sample(y, deterministic=True).item() == pytest.approx(0.3)


def test_cuda_without_card_raises(det, monkeypatch):
    _, m = det
    sd = m.state_dict()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_vocoder(None, TINY, variables=sd, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_vocoder(None, TINY, variables=sd)  # cuda is the default


def test_vocoder_on_cpu(det):
    """make_vocoder on the CPU (the kernel's plain version, float32
    weights): bucketed batch and single-utterance calls, cropped to
    T * hop, against dvc_tpu's scan sampler on the bucket-padded frames."""
    params, m = det
    voc = make_vocoder(None, TINY, seed=0, pad_frames_to=4,
                       variables=m.state_dict(), device="cpu")
    rng = np.random.RandomState(2)
    mels = [rng.rand(4, 3).astype(np.float32), rng.rand(4, 6).astype(np.float32)]
    wavs = voc.batch(mels)
    assert [w.shape for w in wavs] == [(12,), (24,)]
    # both vocoders zero-pad the frames to the bucket (here 8), which the
    # upsampler's kernel carries into the last samples: the reference is the
    # padded utterance, cropped
    padded = np.zeros((1, 8, 4), np.float32)
    padded[0, :6] = mels[1].T
    want = np.asarray(jwn.fast_generate({"params": params}, jnp.asarray(padded),
                                        jax.random.PRNGKey(0), JTINY))[0, :24]
    assert _moves(want)
    np.testing.assert_allclose(voc(mels[1]), want, rtol=TOL, atol=TOL)


@pytest.mark.filterwarnings("ignore:.*weight_norm.*:FutureWarning")
def test_fuse_weight_norm_matches_torch():
    """weight_g/weight_v, the names the reference's weight-normed checkpoint
    carries (the deprecated torch API writes them)."""
    torch.manual_seed(4)
    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 6, 3))
    sd = fuse_weight_norm(dict(conv.state_dict()))
    x = torch.randn(1, 4, 10)
    with torch.no_grad():
        want = conv(x)
        got = torch.nn.functional.conv1d(x, sd["weight"], sd["bias"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)
