"""The AutoVC baselines of the port against dvc_tpu on the CPU, at
tests/test_pipeline.py's width (AutoVCConfig(dim_neck=8, dim_emb=16,
dim_pre=32, freq=8), 16 frames): the three generators in train mode (with
their running statistics) and in eval mode, one train-autovc step (its
terms, every gradient, the updated running statistics), and AutoVCState
files read both ways.

dvc_tpu's step re-encodes the postnet output with the statistics its own
train forward has just updated, and differentiates through them; the port
must too, and a variant whose statistics carry no gradient is shown to
fail the gradient check.  dvc_tpu's gradient is read off its step's Adam
state (after one step optax's first moment is (1 - b1) g)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.models import autovc as jav
from dvc_tpu.train import autovc_trainer as jat
from dvc_tpu_torch.config import AutoVCConfig
from dvc_tpu_torch.models import autovc as pav
from dvc_tpu_torch.models.layers import BatchNorm
from dvc_tpu_torch.train import autovc_trainer as pat
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import autovc_state_dict_from_jax, autovc_tree_from_state_dict

SMALL = dict(dim_neck=8, dim_emb=16, dim_pre=32, freq=8)
B, T = 2, 16
# the full-VAE gate of tests/test_torch_parity.py:234-244: float32 sums in
# another order through 3 convs, 3-4 LSTM layers and the postnet
FULL_RTOL, FULL_ATOL = 1e-3, 1e-4
# the step's scalar terms, its gradients (max |diff| over the parameter's
# max |g|) and the running statistics: the limits of
# tests/test_torch_port_train.py
TERM_RTOL = 1e-5
GRAD_RTOL = 1e-3
STATS_ATOL = 1e-5
# the decoder's and postnet's conv biases sit ahead of a train-mode
# BatchNorm, which subtracts the batch mean: their gradient is 0 in exact
# arithmetic, and both packages return rounding noise, held below this
# share of the same conv's weight gradient (the limit of
# tests/test_torch_port_train.py).  The encoder's are not 0: the content
# term reaches them through the updated running statistics and the
# eval-mode re-encode
PRE_BN_BIAS_SHARE = 1e-4
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, T, 80).astype(np.float32), rng.rand(B, 16).astype(np.float32),
            rng.rand(B, pav.F0_DIMS).astype(np.float32),
            rng.rand(B, T, pav.F0_DIMS).astype(np.float32))


def _pair(kind):
    """(dvc_tpu module, its variables, the port module with its weights)."""
    cfg = JC.AutoVCConfig(**SMALL)
    x, c, f0, _ = _inputs()
    key = jax.random.PRNGKey(1)
    if kind == "proposed":
        jm = jav.ProposedAutoVC(cfg)
        v = jm.init(key, jnp.asarray(x), train=True)
        pm = pav.ProposedAutoVC(AutoVCConfig(**SMALL), frames=T)
    else:
        jm = jav.AutoVCF0(cfg) if kind == "f0" else jav.AutoVC(cfg)
        v = jm.init(key, jnp.asarray(x), jnp.asarray(c), jnp.asarray(c),
                    f0=jnp.asarray(f0) if kind == "f0" else None, train=True)
        pm = pav.AutoVCF0(AutoVCConfig(**SMALL)) if kind == "f0" else \
            pav.AutoVC(AutoVCConfig(**SMALL))
    # move the running statistics off their init, so eval mode reads them
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.3, v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    pm.load_state_dict(autovc_state_dict_from_jax(_np_tree(v["params"]),
                                                  _np_tree(v["batch_stats"])))
    return jm, v, pm


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["autovc", "f0", "f0_frames", "proposed"])
def test_generator(kind, train):
    """Outputs (and the flattened codes) in train and eval mode; in train
    mode also the updated running statistics.  f0: per-utterance pitch
    features; f0_frames: per-frame."""
    jm, v, pm = _pair("f0" if kind.startswith("f0") else kind)
    x, c, f0, f0_frames = _inputs(2)
    f0_in = {"f0": f0, "f0_frames": f0_frames}.get(kind)
    pm.train(train)
    if kind == "proposed":
        want, mut = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
        with torch.no_grad():
            got = pm(torch.from_numpy(x))
    else:
        want, mut = jm.apply(v, jnp.asarray(x), jnp.asarray(c), jnp.asarray(c[::-1]),
                             f0=None if f0_in is None else jnp.asarray(f0_in), train=train,
                             mutable=["batch_stats"])
        with torch.no_grad():
            got = pm(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(c[::-1].copy()),
                     f0=None if f0_in is None else torch.from_numpy(f0_in))
        assert got[2].shape == (B, T // SMALL["freq"] * 2 * SMALL["dim_neck"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FULL_RTOL, atol=FULL_ATOL)
    stats = _leaves(_np_tree(mut["batch_stats"]))
    port_stats = _leaves(autovc_tree_from_state_dict(pm.state_dict())[1])
    assert stats.keys() == port_stats.keys()
    for k in stats:
        np.testing.assert_allclose(port_stats[k], stats[k], atol=STATS_ATOL, err_msg=k)


def test_codes_only_when_no_target():
    """c_trg None: only the flattened codes, the encoder probe of
    conversion time."""
    jm, v, pm = _pair("autovc")
    x, c, _, _ = _inputs(3)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(c), None, train=False)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x), torch.from_numpy(c), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FULL_RTOL, atol=FULL_ATOL)


def _jax_step():
    """dvc_tpu's own train-autovc step -> (its state before (host numpy
    copies), terms, the gradient, the new batch_stats, the new state)."""
    cfg = JC.AutoVCConfig(**SMALL)
    model, state, opt = jat.create_autovc_state(jax.random.PRNGKey(0), cfg, lr=LR, frames=T)
    before = (_np_tree(state.params), _np_tree(state.batch_stats))
    x, c, _, _ = _inputs(4)
    new, total, l_recon, l_content = jat.make_autovc_step(model, opt)(
        state, jnp.asarray(x), jnp.asarray(c))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / 0.1,
                                   new.opt_state[0].mu)
    return before, (float(total), float(l_recon), float(l_content)), grads, new


def _port_step(before):
    model = pav.AutoVC(AutoVCConfig(**SMALL))
    model.load_state_dict(autovc_state_dict_from_jax(*before))
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    x, c, _, _ = _inputs(4)
    terms = pat.make_autovc_step(model, opt)(torch.from_numpy(x), torch.from_numpy(c))
    return model, terms


def _grad_errs(grads, model):
    """Each gradient's max |diff| over its max |g|; the decoder's and
    postnet's conv biases (exactly 0) give their larger share of the conv
    weight's max |g| over PRE_BN_BIAS_SHARE instead."""
    got = _leaves(autovc_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})[0])
    want = _leaves(grads)
    assert got.keys() == want.keys()
    errs = {}
    for k in want:
        if k.endswith("['conv']['bias']") and not k.startswith("['encoder']"):
            w_max = np.abs(want[k.replace("['bias']", "['kernel']")]).max()
            share = max(np.abs(got[k]).max(), np.abs(want[k]).max()) / w_max
            errs[k] = float(share / PRE_BN_BIAS_SHARE * GRAD_RTOL)
        else:
            errs[k] = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
    return errs


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step()


def test_autovc_step(jax_step):
    """One step: total, recon and content terms; every gradient, through
    the updated running statistics; the statistics themselves."""
    before, (total, l_recon, l_content), grads, new = jax_step
    model, terms = _port_step(before)
    for got, want in ((terms.total, total), (terms.recon, l_recon),
                      (terms.content, l_content)):
        assert abs(got.item() - want) <= TERM_RTOL * abs(want)
    assert abs((terms.total - terms.recon - terms.recon_post - terms.content).item()) < 1e-6
    errs = _grad_errs(grads, model)
    assert max(errs.values()) <= GRAD_RTOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    stats = _leaves(_np_tree(new.batch_stats))
    port_stats = _leaves(autovc_tree_from_state_dict(model.state_dict())[1])
    for k in stats:
        np.testing.assert_allclose(port_stats[k], stats[k], atol=STATS_ATOL, err_msg=k)
    assert all(int(b) == 1 for n, b in model.named_buffers() if "num_batches_tracked" in n)


def test_step_without_gradient_through_statistics_fails(jax_step, monkeypatch):
    """The shortcut a plain port takes (running statistics updated under
    no_grad, so the content term does not reach the encoder through them)
    misses dvc_tpu's gradient by more than GRAD_RTOL: the check above can
    tell the two apart."""
    before, _, grads, _ = jax_step
    updated = BatchNorm.updated_stats
    monkeypatch.setattr(BatchNorm, "updated_stats",
                        lambda self, *a: tuple(t.detach() for t in updated(self, *a)))
    model, _ = _port_step(before)
    assert max(_grad_errs(grads, model).values()) > 10 * GRAD_RTOL


def test_autovc_state_read_both_ways(jax_step, tmp_path):
    """dvc_tpu's AutoVCState after a step loads into the port (weights,
    statistics, Adam, step); the port's state after its own step is read by
    dvc_tpu's from_bytes against its template, and the bytes are what flax
    writes for the restored state."""
    _, _, _, new = jax_step
    data = serialization.to_bytes(new)
    model = pav.AutoVC(AutoVCConfig(**SMALL))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    assert pat.load_autovc_state(msgpack.unpackb(data), model, opt) == 1
    params, stats = autovc_tree_from_state_dict(model.state_dict())
    for want, got in ((new.params, params), (new.batch_stats, stats)):
        w, g = _leaves(_np_tree(want)), _leaves(got)
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    mu = opt.state[model.decoder.linear_projection.linear_layer.weight]["exp_avg"]
    np.testing.assert_array_equal(
        mu.numpy().T, np.asarray(new.opt_state[0].mu["decoder"]["linear_projection"]["dense"]
                                 ["kernel"]))

    model.train()
    x, c, _, _ = _inputs(5)
    pat.make_autovc_step(model, opt)(torch.from_numpy(x), torch.from_numpy(c))
    blob = msgpack.packb(pat.autovc_state_tree(model, opt, 2))
    (tmp_path / "autovc_1.msgpack").write_bytes(blob)
    _, template, _ = jat.create_autovc_state(jax.random.PRNGKey(3), JC.AutoVCConfig(**SMALL),
                                             lr=LR, frames=T)
    restored = serialization.from_bytes(template, blob)
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    # a trained state's dicts are sorted (jax's flattening), as the port writes them
    assert serialization.to_bytes(jax.tree_util.tree_map(lambda a: a, restored)) == blob
    got = _leaves(_np_tree(restored.params))
    want = _leaves(autovc_tree_from_state_dict(model.state_dict())[0])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
