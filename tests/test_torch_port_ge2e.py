"""The GE2E speaker encoder of the port against dvc_tpu on the CPU, at a
small width (hidden 32, 3 layers, 4 speakers x 5 utterances x 16 frames):
the encoder's forward, the similarity matrix and loss, all-zero
embeddings, one optimizer step (loss, similarity matrix, the scaled and
clipped gradients, the updated weights), the EER functions, both samplers
(bit-equal batches), compute_partial_slices and embed_utterance, and
GE2EState files read both ways.

The same seeded numpy inputs and weights (through
speaker_encoder_state_dict_from_jax) go to both packages; dvc_tpu's step is
built with mesh=None, so the 8 virtual CPU devices of tests/conftest.py do
not shard it.  dvc_tpu's gradient is read off its step's Adam state: after
one step optax's first moment is (1 - b1) g."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.data import speaker_dataset as jds
from dvc_tpu.eval import eer as jeer
from dvc_tpu.models.speaker_encoder import SpeakerEncoder as JaxEncoder
from dvc_tpu.models.speaker_inference import SpeakerEmbedder as JaxEmbedder
from dvc_tpu.models.speaker_inference import compute_partial_slices as jax_slices
from dvc_tpu.train import speaker_trainer as jst
from dvc_tpu_torch.config import SpeakerEncoderConfig
from dvc_tpu_torch.data import speaker_dataset as pds
from dvc_tpu_torch.eval import eer as peer
from dvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from dvc_tpu_torch.models.speaker_inference import SpeakerEmbedder, compute_partial_slices
from dvc_tpu_torch.train import speaker_trainer as pst
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import (speaker_encoder_state_dict_from_jax,
                                         speaker_encoder_tree_from_state_dict)

SMALL = dict(hidden_size=32, embedding_size=32, num_layers=3, speakers_per_batch=4,
             utterances_per_speaker=5, partials_n_frames=16)
S, U, T = 4, 5, 16
# one layer's gate of tests/test_torch_parity.py: float32 sums in another
# order through three LSTM layers
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
# the similarity matrix (of its max) and the loss: sums of 32 products and
# a softmax over 4, ~1e-7 measured
SIM_RTOL = 1e-5
TERM_RTOL = 1e-5
# gradients, max |diff| over the parameter's max |g| (the limit of
# tests/test_torch_port_train.py)
GRAD_RTOL = 1e-3
# the two similarity gradients are means over the rows of sums of terms of
# size up to 1 that cancel: for the bias exactly (it shifts every logit
# alike), for the weight nearly while the embeddings are alike (at init,
# 3.5e-5 before the 0.01 scaling).  They are held absolutely, to 1e-6 of a
# term's size times the 0.01 (5.5e-10 measured, the bias 1.3e-10 from 0)
SIM_GRAD_ATOL = 1e-8
# Adam's first step is lr g / (|g| + eps): where |g| is above 100 eps both
# packages step the same way up to float32 rounding of the weight; every
# step is at most lr
RESOLVED_G = 1e-6
UPDATE_ATOL = 1e-6
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_model(seed=0):
    jm = JaxEncoder(JC.SpeakerEncoderConfig(**SMALL))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, T, 80)))["params"]
    return jm, params


def _port_model(params):
    pm = SpeakerEncoder(SpeakerEncoderConfig(**SMALL))
    pm.load_state_dict(speaker_encoder_state_dict_from_jax(_np_tree(params)))
    return pm


def _batch(seed=0):
    return np.random.RandomState(seed).rand(S, U, T, 80).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_encoder_forward():
    jm, params = _jax_model()
    x = _batch().reshape(S * U, T, 80)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_similarity_matrix_and_loss():
    jm, params = _jax_model()
    e = np.random.RandomState(1).rand(S, U, 32).astype(np.float32)
    e /= np.linalg.norm(e, axis=2, keepdims=True)
    loss_j, sim_j = jm.apply({"params": params}, jnp.asarray(e), method="loss")
    loss_p, sim_p = _port_model(params).loss(torch.from_numpy(e))
    assert sim_p.shape == (S * U, S)
    assert _rel(sim_j, sim_p.detach().numpy()) <= SIM_RTOL
    assert abs(loss_p.item() - float(loss_j)) <= TERM_RTOL * abs(float(loss_j))


def test_zero_embeddings_finite_loss_and_grad():
    """A ReLU-dead speaker (all-zero embeddings) gives a finite loss and
    gradient: the safe normalize, not F.normalize's clamp."""
    _, params = _jax_model()
    e = np.random.RandomState(4).rand(S, U, 32).astype(np.float32)
    e[0] = 0.0
    et = torch.from_numpy(e).requires_grad_(True)
    loss, _ = _port_model(params).loss(et)
    loss.backward()
    assert np.isfinite(loss.item()) and torch.isfinite(et.grad).all()


def _jax_step(params, batch):
    """dvc_tpu's own step (mesh=None) from ``params`` -> (loss, sim, the
    gradient Adam was given, new params)."""
    cfg = JC.SpeakerEncoderConfig(**SMALL, learning_rate=LR)
    model = JaxEncoder(cfg)
    opt = jst.make_ge2e_optimizer(cfg.learning_rate)
    params = jax.tree_util.tree_map(jnp.array, params)  # the step donates its state
    state = jst.GE2EState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=opt.init(params))
    new, loss, sim = jst.make_ge2e_step(model, opt, cfg, mesh=None)(state, jnp.asarray(batch))
    mu = new.opt_state[2][0].mu
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / 0.1, mu)
    return float(loss), np.asarray(sim), grads, _np_tree(new.params)


def _port_step(params, batch):
    pm = _port_model(params).train()
    opt = torch.optim.Adam(pm.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    loss, sim = pst.make_ge2e_step(pm, opt)(torch.from_numpy(batch))
    grads = {n: p.grad.clone() for n, p in pm.named_parameters()}
    return loss.item(), sim.numpy(), grads, pm


@pytest.mark.parametrize("clipped", [False, True])
def test_ge2e_step(clipped):
    """One step against make_ge2e_step(mesh=None): loss, similarity matrix,
    gradients after the similarity scaling and the clip, and the updated
    weights.  clipped: a batch scaled so that the global norm is above 3
    (the clip multiplies) or not (it passes)."""
    _, params = _jax_model(1)
    batch = _batch(2) * (40.0 if clipped else 1.0)
    loss_j, sim_j, g_j, new_j = _jax_step(params, batch)
    loss_p, sim_p, g_p, pm = _port_step(params, batch)
    assert abs(loss_p - loss_j) <= TERM_RTOL * abs(loss_j)
    assert _rel(sim_j, sim_p) <= SIM_RTOL
    g_tree = speaker_encoder_tree_from_state_dict(g_p)
    flat_j = jax.tree_util.tree_leaves_with_path(g_j)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(g_tree))
    norm = np.sqrt(sum((np.asarray(g) ** 2).sum() for _, g in flat_j))
    assert (norm >= 3.0 - 1e-6) == clipped, norm
    for path, gj in flat_j:
        name = jax.tree_util.keystr(path)
        if "similarity" in name:
            assert np.abs(gj - flat_p[path]).max() <= SIM_GRAD_ATOL, name
            if "bias" in name:
                assert max(np.abs(gj).max(), np.abs(flat_p[path]).max()) <= SIM_GRAD_ATOL
            continue
        assert _rel(gj, flat_p[path]) <= GRAD_RTOL, name
    new_p = dict(jax.tree_util.tree_leaves_with_path(
        speaker_encoder_tree_from_state_dict(pm.state_dict())))
    old = dict(jax.tree_util.tree_leaves_with_path(_np_tree(params)))
    for path, wj in jax.tree_util.tree_leaves_with_path(new_j):
        sure = np.abs(dict(flat_j)[path]) > RESOLVED_G
        d = np.abs(new_p[path] - wj)
        assert d[sure].max(initial=0.0) <= UPDATE_ATOL, jax.tree_util.keystr(path)
        assert np.abs(new_p[path] - old[path]).max() <= LR * (1 + 1e-3)


def test_eer_functions_equal_dvc_tpus():
    rng = np.random.RandomState(5)
    labels, scores = rng.randint(0, 2, 300), rng.randn(300)
    assert peer.equal_error_rate(labels, scores) == jeer.equal_error_rate(labels, scores)
    sim = rng.randn(S * U, S) + 2.0 * np.eye(S)[np.repeat(np.arange(S), U)]
    assert peer.ge2e_eer(sim, S, U) == jeer.ge2e_eer(sim, S, U)
    embeds, ids = rng.randn(40, 8), np.repeat(np.arange(5), 8)
    embeds += 3.0 * rng.randn(5, 8)[ids]
    got = peer.verification_eer(embeds, ids, max_pairs=300, seed=2)
    assert got == jeer.verification_eer(embeds, ids, max_pairs=300, seed=2)
    assert 0.0 <= got < 0.5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """5 speakers x 3 utterances of 30, 12 and 55 frames (12 < the 20-frame
    crop: zero-padded; 55: longer than a 40-frame residency cap)."""
    root = tmp_path_factory.mktemp("spk")
    rng = np.random.RandomState(7)
    for s in range(5):
        (root / f"spk{s}").mkdir()
        for u, t in enumerate((30, 12, 55)):
            np.save(root / f"spk{s}" / f"u{u}.npy", rng.rand(80, t).astype(np.float32))
    return root


def test_host_sampler_bit_equal(corpus):
    want = jds.SpeakerVerificationSampler(str(corpus), 4, 2, 20, seed=3)
    got = pds.SpeakerVerificationSampler(str(corpus), 4, 2, 20, seed=3)
    for _ in range(6):
        np.testing.assert_array_equal(got.next_batch(), want.next_batch())


@pytest.mark.parametrize("cap", [1000, 40])
def test_resident_sampler_bit_equal(corpus, cap):
    """The pool on the (CPU) device gathers the same crops as dvc_tpu's
    resident sampler and its host sampler: the zero-padded short utterance,
    and with cap 40 the truncated 55-frame one."""
    want = jds.DeviceResidentSampler(str(corpus), 4, 2, 20, seed=3, max_resident_frames=cap)
    got = pds.DeviceResidentSampler(str(corpus), 4, 2, 20, seed=3, max_resident_frames=cap,
                                    device="cpu")
    assert tuple(got.pool.shape) == (15, cap, 80) and got.pool.device.type == "cpu"
    for _ in range(6):
        b = got.next_batch()
        assert b.shape == (4, 2, 20, 80) and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(want.next_batch()))


def test_resident_sampler_budget(corpus):
    with pytest.raises(MemoryError):
        pds.DeviceResidentSampler(str(corpus), 2, 2, 20, memory_budget_bytes=1024,
                                  device="cpu")


@pytest.mark.parametrize("n_samples", [100, 16_000, 23_457, 64_000])
def test_compute_partial_slices(n_samples):
    for spf in (None, 256):
        assert compute_partial_slices(n_samples, 63, samples_per_frame=spf) == \
            jax_slices(n_samples, 63, samples_per_frame=spf)


@pytest.mark.parametrize("using_partials", [True, False])
def test_embed_utterance(using_partials):
    _, params = _jax_model(3)
    rng = np.random.RandomState(6)
    t = np.arange(20_000) / 16_000
    wav = (0.3 * np.sin(2 * np.pi * 170 * t) + 0.05 * rng.randn(len(t))).astype(np.float32)
    jemb = JaxEmbedder(JC.SpeakerEncoderConfig(**SMALL))
    jemb.load(params)
    pemb = SpeakerEmbedder(SpeakerEncoderConfig(**SMALL), device="cpu")
    pemb.load(speaker_encoder_state_dict_from_jax(_np_tree(params)))
    want = jemb.embed_utterance(wav, using_partials=using_partials, return_partials=True)
    got = pemb.embed_utterance(wav, using_partials=using_partials, return_partials=True)
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_RTOL, atol=FWD_ATOL)
    assert abs(np.linalg.norm(got[0]) - 1.0) < 1e-5
    if using_partials:
        np.testing.assert_allclose(got[1], want[1], rtol=FWD_RTOL, atol=FWD_ATOL)
        assert got[2] == want[2]


def _trained_jax_trainer(models_dir):
    cfg = JC.SpeakerEncoderConfig(**SMALL)
    tr = jst.SpeakerEncoderTrainer(cfg, run_id="ge2e", models_dir=str(models_dir),
                                   use_mesh=False)
    batch = jnp.asarray(_batch(8))
    for _ in range(2):
        tr.state, _ = tr.step_fn_light(tr.state, batch)
    return tr


def test_ge2e_state_read_both_ways(tmp_path):
    """dvc_tpu's {run_id}.msgpack after two steps resumes in the port
    (weights, Adam moments, step); the port's after one more step resumes
    in dvc_tpu, and its backup file is the same state."""
    jt = _trained_jax_trainer(tmp_path)
    jt.save()
    pt = pst.SpeakerEncoderTrainer(SpeakerEncoderConfig(**SMALL), models_dir=str(tmp_path),
                                   device="cpu")
    assert pt.resume() and pt.step == 2
    got = dict(jax.tree_util.tree_leaves_with_path(
        speaker_encoder_tree_from_state_dict(pt.model.state_dict())))
    for path, want in jax.tree_util.tree_leaves_with_path(_np_tree(jt.state.params)):
        np.testing.assert_array_equal(got[path], want)
    adam = pt.optimizer.state[pt.model.linear.weight]
    np.testing.assert_array_equal(adam["exp_avg"].numpy().T,
                                  np.asarray(jt.state.opt_state[2][0].mu["linear"]["kernel"]))
    assert int(adam["step"]) == 2

    pt.step_fn(torch.from_numpy(_batch(9)), with_sim=False)
    pt.step += 1
    pt.save(backup=True)
    bak = tmp_path / "ge2e_bak_000003.msgpack"
    assert bak.read_bytes() == (tmp_path / "ge2e.msgpack").read_bytes()
    jt2 = jst.SpeakerEncoderTrainer(JC.SpeakerEncoderConfig(**SMALL), models_dir=str(tmp_path),
                                    use_mesh=False)
    assert jt2.resume() and int(jt2.state.step) == 3
    want = dict(jax.tree_util.tree_leaves_with_path(
        speaker_encoder_tree_from_state_dict(pt.model.state_dict())))
    for path, got in jax.tree_util.tree_leaves_with_path(_np_tree(jt2.state.params)):
        np.testing.assert_array_equal(got, want[path])
    # the file is exactly the tree flax writes for the state it restores to
    assert serialization.to_bytes(jt2.state) == (tmp_path / "ge2e.msgpack").read_bytes()
    tree = msgpack.unpackb(bak.read_bytes())
    assert list(tree) == ["step", "params", "opt_state"]
    assert list(tree["opt_state"]) == ["0", "1", "2"] and tree["opt_state"]["0"] == {}
