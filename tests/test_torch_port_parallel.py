"""The port's mesh layer (dvc_tpu_torch/parallel) against dvc_tpu's
parallel/ on the CPU: mesh shapes, the ZeRO and tensor-parallel rules on
the full-size VAE, multihost's degenerate path, the one-process step
unchanged by the default ``use_mesh``, and, on gloo ranks started by
tests/torch_parallel_ranks.py (which imports no jax), grouped BatchNorm
over 2 ranks, the tiny VAE pair step on 4 ranks (dp 2 x mp 2) against
dvc_tpu's step jitted on a 4x2 mesh, batch 2 on 4 ranks, the adversary's
confusion step and its checkpoint on 2 ranks, ZeRO's moment bytes, and the
GE2E step on 2 ranks against dvc_tpu's make_ge2e_step(mesh=...).

dvc_tpu runs in this process on conftest's 8 CPU devices, its noise
injected as in test_torch_port_train.py; the weights reach the ranks
through a dvc_tpu checkpoint, which their Trainer resumes and shards."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.sharding import NamedSharding, PartitionSpec as P

from dvc_tpu import config as JC
from dvc_tpu.models.disentangled_vae import DisentangledVAE as JaxVAE
from dvc_tpu.parallel import mesh as jmesh
from dvc_tpu.train import checkpoint as jckpt
from dvc_tpu.train.adversarial import AdvState, SpeakerAdversary
from dvc_tpu.train.adversarial import make_adv_train_step as jax_make_adv_train_step
from dvc_tpu.models.speaker_encoder import SpeakerEncoder
from dvc_tpu.train.speaker_trainer import (GE2EState, ge2e_batch_sharding, make_ge2e_optimizer,
                                           make_ge2e_step)
from dvc_tpu.train.trainer import TrainState
from dvc_tpu.train.trainer import make_train_step as jax_make_train_step
from dvc_tpu_torch.config import (Config, LossConfig, MeshConfig, SpeakerEncoderConfig,
                                  TrainConfig, VAEConfig)
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.layers import BatchNorm
from dvc_tpu_torch.parallel import mesh as pmesh
from dvc_tpu_torch.parallel import multihost
from dvc_tpu_torch.train.trainer import Trainer, trainer_dp
from dvc_tpu_torch.utils.convert import (adversary_state_dict_from_jax,
                                         speaker_encoder_state_dict_from_jax,
                                         vae_state_dict_from_jax)
from test_torch_port_adversarial import ADV_COF, ADV_LR, N_SPK, PARAM_RTOL, SPK, VAE_LR, _rel
from test_torch_port_train import (BN_ATOL, GRAD_RTOL, PRE_BN_BIAS_SHARE, SMALL, STATS_ATOL,
                                   TERM_RTOL, _batch, _grab_grads, _injector, _is_pre_bn_bias,
                                   _np_tree)
from torch_parallel_ranks import Ranks, _group_rows

RUN = "DisentangledVAE_VCTK"


def jax_tiny_vae(fused: bool = True, stats_seed: int | None = None):
    """dvc_tpu's tiny VAE and its variables from one jitted init (its eager
    init compiles op by op, ~14 s on a cold cache); with ``stats_seed``
    the BatchNorm running statistics are drawn as test_torch_port_vae's
    ``pair`` draws them."""
    jm = JaxVAE(JC.VAEConfig(**SMALL), pair_fused=fused)
    x = jnp.zeros((2, 80, SMALL["frames"]), jnp.float32)
    v = jax.jit(lambda k: jm.init({"params": k, "reparam": k}, x, x, train=True))(
        jax.random.PRNGKey(0))
    v = {"params": _np_tree(v["params"]), "batch_stats": _np_tree(v["batch_stats"])}
    if stats_seed is not None:
        rng = np.random.RandomState(stats_seed)
        for grp in v["batch_stats"].values():
            for bn in grp.values():
                shape = bn["bn"]["mean"].shape
                bn["bn"]["mean"] = rng.normal(0, 0.1, shape).astype(np.float32)
                bn["bn"]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return jm, v


def jax_adversary():
    """dvc_tpu's speaker adversary for the tiny VAE (28 content dims,
    N_SPK speakers) and its parameters, from one jitted init."""
    am = SpeakerAdversary(n_speakers=N_SPK)
    params = jax.jit(am.init)(jax.random.PRNGKey(2), jnp.zeros((1, 28), jnp.float32))["params"]
    return am, _np_tree(params)


def _port_cfg(**train_kw) -> Config:
    train = {"batch_size": 4, "compute_dtype": "float32", "seed": 3, **train_kw}
    return Config(vae=VAEConfig(**SMALL), train=TrainConfig(**train))


def _jax_ckpt(path, v):
    """dvc_tpu's TrainState of ``v`` with a fresh Adam, as its Trainer saves
    it, at epoch 0 (the ranks resume it as epoch 1)."""
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=optax.adam(1e-4).init(v["params"]))
    jckpt.save_checkpoint(str(path), RUN, 0, state)
    return str(path)


# -- no ranks ----------------------------------------------------------------------

@pytest.mark.parametrize("mp", [1, 2])
def test_mesh_shapes(mp):
    """dvc_tpu's rule on its 8 devices: 8 x 1, and 4 x 2 with model_parallel 2."""
    want = jmesh.make_mesh(JC.MeshConfig(model_parallel=mp))
    assert pmesh.mesh_shape(MeshConfig(model_parallel=mp), 8) == tuple(want.shape.values())
    assert pmesh.mesh_shape(MeshConfig(data_parallel=2, model_parallel=mp), 8) == (2, mp)
    with pytest.raises(ValueError, match="needs more than"):
        pmesh.mesh_shape(MeshConfig(data_parallel=8, model_parallel=2), 8)


def _torch_axes(jax_specs, axis: str) -> dict[str, int | None]:
    """Map dvc_tpu's per-leaf specs onto the port's names and dims through
    vae_state_dict_from_jax: a marker that counts along the sharded axis
    shows, after the bridge's transposes, which torch dim it became."""
    def marker(spec):
        shape = spec["shape"]
        named = [i for i, a in enumerate(spec["spec"]) if a == axis]
        out = np.zeros(shape, np.float32)
        if named:
            idx = [None] * len(shape)
            idx[named[0]] = slice(None)
            out += np.arange(shape[named[0]], dtype=np.float32)[tuple(idx)]
        return out

    sd = vae_state_dict_from_jax(jax.tree_util.tree_map(
        marker, jax_specs, is_leaf=lambda x: isinstance(x, dict) and "spec" in x), None)
    out = {}
    for name, t in sd.items():
        varies = [d for d in range(t.ndim) if t.shape[d] > 1
                  and bool((t.diff(dim=d) != 0).any())]
        assert len(varies) <= 1, name
        out[name] = varies[0] if varies else None
    return out


@pytest.mark.parametrize("rule", ["zero", "param"])
def test_sharding_rules_full_size(rule):
    """At the full VAEConfig on dvc_tpu's 4 x 2 mesh: the port's ZeRO and
    column-parallel rules shard the same tensors on the same axes as
    dvc_tpu's specs on its tree (pre_linear2 replicated)."""
    cfg = JC.Config()
    jm = JaxVAE(cfg.vae, pair_fused=cfg.vae.pair_fused)
    x = jnp.zeros((2, 80, cfg.vae.frames), jnp.float32)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: jm.init({"params": key, "reparam": key}, x, x,
                                            train=True))["params"]
    mesh = jmesh.make_mesh(JC.MeshConfig(model_parallel=2))
    if rule == "zero":
        specs = jmesh.zero_sharding_for(jax.eval_shape(optax.adam(1e-4).init, params),
                                        mesh)[0].mu
    else:
        specs = jmesh.param_sharding_for(params, mesh)
    leaves = jax.tree_util.tree_map(lambda p, s: {"shape": p.shape, "spec": tuple(s.spec)},
                                    params, specs)
    want = _torch_axes(leaves, "data" if rule == "zero" else "model")
    shapes = {n: tuple(p.shape) for n, p in DisentangledVAE(VAEConfig()).named_parameters()}
    assert set(shapes) == set(want)
    if rule == "zero":
        got = {n: pl[0] for n, pl in pmesh.zero_sharding_for(shapes, {"data": 4, "model": 2}
                                                             ).items()}
    else:
        got = {n: pl[1] for n, pl in pmesh.param_sharding_for(shapes, {"data": 4, "model": 2}
                                                              ).items()}
    got = {n: p.dim if isinstance(p, pmesh.Shard) else None for n, p in got.items()}
    assert got == want
    assert sum(d is not None for d in got.values()) > 20
    if rule == "param":
        assert got["dec_pre_linear2.weight"] is None
        assert got["dec_lstm2.weight_hh_l0"] == 1 and got["enc_linear.linear_layer.weight"] == 0


def test_multihost_degenerate():
    """One process without torchrun's environment: no process group."""
    assert multihost.initialize_distributed(device="cpu") is False
    assert multihost.is_primary()
    mesh = multihost.global_mesh(MeshConfig(), "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    b = multihost.PerHostBatcher(mesh)
    assert b.local_batch_size(16) == 16
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    np.testing.assert_array_equal(b.global_batch(x).numpy(), x)


def test_one_process_step_unchanged():
    """The default use_mesh without a process group is today's step, bit
    for bit: the same terms, weights, Adam state and BN statistics."""
    x1, x2, _ = _batch(12)
    x1, x2 = torch.from_numpy(x1), torch.from_numpy(x2)
    runs = []
    for use_mesh in (True, False):
        tr = Trainer(_port_cfg(), use_mesh=use_mesh, device="cpu")
        assert tr.mesh is None and isinstance(tr.optimizer, torch.optim.Adam)
        terms = [tr.step_on(x1, x2) for _ in range(2)]
        runs.append((terms, tr.model.state_dict(), tr.optimizer.state_dict()["state"]))
    (ta, sa, oa), (tb, sb, ob) = runs
    for a, b in zip(ta, tb):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
    for i in oa:
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i])


# -- grouped BatchNorm, the adversarial step, its checkpoint, GE2E: 2 ranks ---------

GE2E = dict(speakers_per_batch=16, utterances_per_speaker=3, hidden_size=32,
            embedding_size=16, num_layers=2)


def _bn_inputs(groups):
    rng = np.random.RandomState(40 + groups)
    c, t = 6, 5
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.randn(c).astype(np.float32),
            "x": [rng.randn(8, c, t).astype(np.float32) * 2 + 0.5 for _ in range(2)],
            "gy": [rng.randn(8, c, t).astype(np.float32) for _ in range(2)]}


def _jax_adv_step_jit(v, a_params, x1, x2, eps):
    """dvc_tpu's adversarial step (confusion), jitted, on injected noise;
    the optimizer keeps the gradients as its state."""
    jm = JaxVAE(JC.VAEConfig(**SMALL), pair_fused=True)
    am = SpeakerAdversary(n_speakers=N_SPK)
    opt = _grab_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    adv_state = AdvState(params=a_params, opt_state=opt.init(a_params))
    icpt, calls = _injector(eps)
    step = jax_make_adv_train_step(jm, opt, am, opt, adv_cof=ADV_COF, mode="confusion",
                                   compute_dtype="float32", jit=False)
    with fnn.intercept_methods(icpt):
        out = jax.jit(step)(state, adv_state, jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(SPK), jax.random.PRNGKey(0))
    assert len(calls) == 3
    return out


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The 2-rank scenario's results and what they are held to."""
    tmp = tmp_path_factory.mktemp("dp2")
    _, v = jax_tiny_vae()
    _, a_params = jax_adversary()
    x1, x2, eps = _batch(21)
    cfg = _port_cfg(learning_rate=VAE_LR)
    cfg = cfg.replace(loss=LossConfig(adv_cof=ADV_COF, adv_speakers=N_SPK, adv_lr=ADV_LR))
    gcfg = JC.SpeakerEncoderConfig(**GE2E)
    model, gopt = SpeakerEncoder(gcfg), make_ge2e_optimizer(gcfg.learning_rate)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros(
        (2, gcfg.partials_n_frames, gcfg.mel_n_channels)))["params"]
    gstate = GE2EState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=gopt.init(params))
    rng = np.random.RandomState(0)
    batches = [rng.rand(16, 3, 20, 80).astype(np.float32) for _ in range(3)]
    inputs = {"cfg": cfg, "ck": _jax_ckpt(tmp / "ck", v), "ock": str(tmp / "ock"),
              "x1": x1, "x2": x2, "eps": eps, "spk": SPK, "adv_sd": adversary_state_dict_from_jax(_np_tree(a_params)),
              "bn": {g: _bn_inputs(g) for g in (1, 2)},
              "ge2e_cfg": SpeakerEncoderConfig(**GE2E),
              "ge2e_sd": speaker_encoder_state_dict_from_jax(_np_tree(gstate.params)),
              "ge2e_batches": batches}
    ranks = Ranks("dp2", 2, tmp / "ranks", inputs)
    # dvc_tpu's side, while the ranks run
    new, new_adv, terms, metrics = _jax_adv_step_jit(v, a_params, x1, x2, eps)
    jmesh8 = jmesh.make_mesh(JC.MeshConfig(data_parallel=8, model_parallel=1))
    step = make_ge2e_step(model, gopt, gcfg, with_sim=False, mesh=jmesh8)
    losses = []
    for b in batches:
        gstate, loss = step(gstate, jax.device_put(jnp.asarray(b), ge2e_batch_sharding(jmesh8)))
        losses.append(float(loss))
    return {"ranks": ranks.results(), "inputs": inputs, "v": v, "a_params": a_params,
            "adv": (new, new_adv, terms, metrics), "ge2e": losses}


@pytest.mark.parametrize("groups", [1, 2])
def test_grouped_bn_two_ranks(dp2, groups):
    """BatchNorm over a batch sharded on 2 ranks against the one-process
    BatchNorm on the whole batch: outputs, input gradients and the running
    statistics after two train calls."""
    inp = dp2["inputs"]["bn"][groups]
    bn = BatchNorm(6, groups=groups).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
    for call, (x, gy) in enumerate(zip(inp["x"], inp["gy"])):
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(gy)).sum().backward()
        for r, res in enumerate(dp2["ranks"]):
            got = res[f"bn{groups}"]
            np.testing.assert_allclose(got["y"][call].numpy(),
                                       _group_rows(y.detach().numpy(), groups, 2, r),
                                       atol=BN_ATOL)
            np.testing.assert_allclose(got["dx"][call].numpy(),
                                       _group_rows(xt.grad.numpy(), groups, 2, r),
                                       atol=BN_ATOL)
    for res in dp2["ranks"]:
        np.testing.assert_allclose(res[f"bn{groups}"]["mean"].numpy(),
                                   bn.running_mean.numpy(), atol=BN_ATOL)
        np.testing.assert_allclose(res[f"bn{groups}"]["var"].numpy(),
                                   bn.running_var.numpy(), atol=BN_ATOL)


def test_multihost_two_ranks(dp2):
    """At world 2: initialize_distributed reports a multi-process world,
    rank 0 alone is primary, and each rank gets half the batch, its rows."""
    for r, res in enumerate(dp2["ranks"]):
        m = res["multihost"]
        assert m["init"] is True and m["primary"] == (r == 0) and m["mesh"] == (2, 1)
        assert m["local_bs"] == 8
        want = np.arange(64, dtype=np.float32).reshape(16, 4)[8 * r:8 * (r + 1)]
        np.testing.assert_array_equal(m["rows"].numpy(), want)


def test_ranks_walk_one_batch(dp2):
    """Under a mesh, a host batch that differs between the ranks (an
    unseeded dataset) is refused on every rank; an equal one passes."""
    for res in dp2["ranks"]:
        assert res["same_batch"] == [True, False]


@pytest.mark.parametrize("world,batch,mp,dp", [(1, 8, 1, 1), (2, 8, 1, 2), (3, 8, 1, 1),
                                               (4, 2, 1, 2), (5, 8, 1, 1), (6, 8, 1, 2),
                                               (8, 8, 2, 4)])
def test_trainer_dp(world, batch, mp, dp):
    """The Trainer's data axis divides the batch and leaves the world a
    whole number of dp x mp meshes, so make_mesh accepts every world."""
    cfg = _port_cfg(batch_size=batch)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, model_parallel=mp))
    assert trainer_dp(cfg, world) == dp
    assert batch % dp == 0 and world % (dp * mp) == 0


def _check_grads(got, ref):
    for name, w in ref.items():
        g = got[name].numpy()
        w = w.numpy()
        if _is_pre_bn_bias(name):
            w_max = np.abs(ref[name[:-len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= PRE_BN_BIAS_SHARE * w_max, name
            continue
        assert _rel(g, w) <= GRAD_RTOL, (name, _rel(g, w))


def test_adversary_step_two_ranks(dp2):
    """The confusion-mode adversarial step on 2 ranks (the z-score over the
    global batch) against dvc_tpu's: loss terms, adv_ce and adv_acc, both
    nets' gradients, the BN statistics, on both ranks alike."""
    new, new_adv, want, wm = dp2["adv"]
    ref = vae_state_dict_from_jax(_np_tree(new.opt_state), _np_tree(new.batch_stats))
    ref_adv = adversary_state_dict_from_jax(_np_tree(new_adv.opt_state))
    for res in dp2["ranks"]:
        got = res["adv"]
        for name, w, g in zip(want._fields, want, got["terms"]):
            np.testing.assert_allclose(g, float(w), rtol=TERM_RTOL, err_msg=name)
        np.testing.assert_allclose(got["metrics"][0], float(wm["adv_ce"]), rtol=TERM_RTOL)
        assert got["metrics"][1] == float(wm["adv_acc"])
        _check_grads(got["grads"], {n: t for n, t in ref.items() if "running" not in n
                                    and "num_batches" not in n})
        _check_grads(got["adv_grads"], ref_adv)
        for name, s in got["stats"].items():
            np.testing.assert_allclose(s.numpy(), ref[name].numpy(), atol=STATS_ATOL,
                                       err_msg=name)


def test_checkpoint_two_ranks(dp2):
    """Rank 0's checkpoint after the 2-rank step (the shards and ZeRO
    moments gathered) resumes in the one-process port and loads in
    dvc_tpu: the same weights, Adam's count 1 and moments, and weights
    within Adam's step of dvc_tpu's update (where its gradient is resolved,
    PARAM_RTOL of the weight)."""
    ck = dp2["inputs"]["ck"]
    one = Trainer(_port_cfg(), checkpoints_path=ck, device="cpu")
    assert one.load_last() == 2 and one.step == 1
    v, (new, _, _, _) = dp2["v"], dp2["adv"]
    template = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=optax.adam(1e-4).init(v["params"]))
    epoch, jstate = jckpt.load_last_checkpoint(ck, template)
    assert epoch == 1 and int(jstate.step) == 1
    assert int(jstate.opt_state[0].count) == 1
    sd_j = vae_state_dict_from_jax(_np_tree(jstate.params), _np_tree(jstate.batch_stats))
    old = vae_state_dict_from_jax(_np_tree(v["params"]), None)
    grads = vae_state_dict_from_jax(_np_tree(new.opt_state), None)
    # optax.adam's first step: mu_hat = g, nu_hat = g ** 2
    upd = {n: old[n] - VAE_LR * g / (g.abs() + 1e-8) for n, g in grads.items()}
    mu = vae_state_dict_from_jax(_np_tree(jstate.opt_state[0].mu), None)
    state = one.optimizer.state_dict()["state"]
    for i, (name, p) in enumerate(one.model.named_parameters()):
        got = p.detach().numpy()
        assert np.array_equal(got, sd_j[name].numpy()), name
        assert np.array_equal(state[i]["exp_avg"].numpy(), mu[name].numpy()), name
        assert np.abs(got - old[name].numpy()).max() <= VAE_LR * (1 + 1e-6) + np.spacing(
            np.abs(old[name].numpy()).max()), name
        if _is_pre_bn_bias(name):
            continue
        g = grads[name].numpy()
        assert _rel(state[i]["exp_avg"].numpy() / 0.1, g) <= GRAD_RTOL, name
        sure = np.abs(g) > GRAD_RTOL * np.abs(g).max()
        err = np.abs(got - upd[name].numpy())[sure]
        assert err.size == 0 or err.max() <= PARAM_RTOL * np.abs(upd[name].numpy()).max(), name


def _check_sharded_orbax(msgpack_dir: str, orbax_dir: str, world: int, mesh_shape) -> None:
    """The ranks' sharded orbax checkpoint holds one store a rank, each
    with chunks; dvc_tpu restores it, with its own mesh's shardings and
    without, bit-equal to the msgpack checkpoint of the same state; the
    one-process port resumes from it to the msgpack resume's state (but
    BatchNorm's num_batches_tracked, which dvc_tpu's tree has no place for
    and the port's BatchNorm, with its fixed momentum, never reads)."""
    import os
    from dvc_tpu_torch.utils import ocdbt
    path = os.path.join(orbax_dir, f"{RUN}_1.orbax")
    for r in range(world):
        keys = ocdbt.read_entries(os.path.join(path, f"ocdbt.process_{r}"))
        assert any(not k.endswith(b"/.zarray") for k in keys), r
    assert sorted(os.listdir(orbax_dir)) == [f"{RUN}_1.orbax"]  # no .pth pair: no gather
    _, v = jax_tiny_vae()
    template = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=optax.adam(1e-4).init(v["params"]))
    want = jax.tree_util.tree_leaves(jckpt.load_last_checkpoint(msgpack_dir, template)[1])
    mesh = jmesh.make_mesh(JC.MeshConfig(**mesh_shape))
    for sh in (None, jmesh.train_state_shardings(template, mesh, shard_opt_state=True)):
        epoch, got = jckpt.load_last_checkpoint(orbax_dir, template, shardings=sh)
        got = jax.tree_util.tree_leaves(got)
        assert epoch == 1 and len(got) == len(want)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(np.asarray(a), np.asarray(b))
    resumed = []
    for d in (msgpack_dir, orbax_dir):
        one = Trainer(_port_cfg(), checkpoints_path=d, device="cpu")
        assert one.load_last() == 2 and one.step == 1
        resumed.append((one.model.state_dict(), one.optimizer.state_dict()["state"]))
    (sa, oa), (sb, ob) = resumed
    for n in sa:
        assert n.endswith("num_batches_tracked") or torch.equal(sa[n], sb[n]), n
    for i in oa:
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in ("exp_avg", "exp_avg_sq")), i


def test_orbax_two_ranks(dp2):
    """Both ranks of dp 2 write their ZeRO chunks into their own store."""
    _check_sharded_orbax(dp2["inputs"]["ck"], dp2["inputs"]["ock"], 2,
                         {"data_parallel": 2, "model_parallel": 1})


def test_ge2e_two_ranks(dp2):
    """The GE2E step with each rank embedding half the speakers against
    dvc_tpu's make_ge2e_step on its 8-device mesh, 3 steps, both ranks."""
    for res in dp2["ranks"]:
        np.testing.assert_allclose(res["ge2e"], dp2["ge2e"], rtol=2e-5, atol=1e-6)


# -- the pair step on 4 ranks, dp 2 x mp 2 ---------------------------------------------

def _jax_mesh_step(v, x1, x2, eps):
    """dvc_tpu's step jitted under train_state_shardings on its 4 x 2 mesh
    (tests/test_parallel.py:160-215), on injected noise; the optimizer
    keeps the gradients as its state."""
    jm = JaxVAE(JC.VAEConfig(**SMALL), pair_fused=True)
    opt = _grab_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    mesh = jmesh.make_mesh(JC.MeshConfig(model_parallel=2))
    state_sh = jmesh.train_state_shardings(state, mesh, shard_opt_state=True)
    batch_sh = jmesh.data_sharding(mesh, ndim=3)
    step = jax.jit(jax_make_train_step(jm, opt, compute_dtype="float32", donate=False,
                                       jit=False),
                   in_shardings=(state_sh, batch_sh, batch_sh, NamedSharding(mesh, P())),
                   out_shardings=(state_sh, None))
    icpt, calls = _injector(eps)
    with fnn.intercept_methods(icpt), mesh:
        new, terms = step(jax.device_put(state, state_sh), jax.device_put(x1, batch_sh),
                          jax.device_put(x2, batch_sh), jax.random.PRNGKey(0))
    assert len(calls) == 3
    return new, terms


@pytest.fixture(scope="module")
def dp2mp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp2mp2")
    _, v = jax_tiny_vae()
    x1, x2, eps = _batch(22)
    cfg = _port_cfg().replace(mesh=MeshConfig(model_parallel=2))
    inputs = {"cfg": cfg, "cfg_b2": _port_cfg(batch_size=2), "ck": _jax_ckpt(tmp / "ck", v),
              "ck2": str(tmp / "ck2"), "ock": str(tmp / "ock"), "x1": x1, "x2": x2, "eps": eps}
    ranks = Ranks("vae4", 4, tmp / "ranks", inputs)
    want = _jax_mesh_step(v, x1, x2, eps)
    return {"ranks": ranks.results(), "inputs": inputs, "jax": want}


def test_pair_step_dp2_mp2(dp2mp2):
    """The tiny VAE pair step on 4 ranks, dp 2 x mp 2 (column-parallel
    Linear/Conv1d, gathered LSTM weights, BN over the data axis, ZeRO Adam)
    against dvc_tpu's 4 x 2 mesh step: loss terms, every gradient, the BN
    running statistics, on every rank."""
    new, want = dp2mp2["jax"]
    ref = vae_state_dict_from_jax(_np_tree(new.opt_state), _np_tree(new.batch_stats))
    tp = dp2mp2["ranks"][0]["tp_dims"]
    assert isinstance(tp["enc_linear.linear_layer.weight"], pmesh.Shard)
    assert isinstance(tp["dec_lstm2.weight_hh_l0"], pmesh.Shard)
    for res in dp2mp2["ranks"]:
        got = res["step"]
        for name, w, g in zip(want._fields, want, got["terms"]):
            np.testing.assert_allclose(g, float(w), rtol=TERM_RTOL, err_msg=name)
        _check_grads(got["grads"], {n: t for n, t in ref.items() if "running" not in n
                                    and "num_batches" not in n})
        for name, s in got["stats"].items():
            np.testing.assert_allclose(s.numpy(), ref[name].numpy(), atol=STATS_ATOL,
                                       err_msg=name)


def test_batch_2_on_4_ranks(dp2mp2):
    """Batch 2 on 4 ranks: dp falls to 2 (two replicas of the 2 x 1 mesh);
    Trainer.step_on draws the global batch's noise and keeps its rows, so
    the terms are the one-process step's; the replicas hold equal weights."""
    one = Trainer(_port_cfg(batch_size=2), device="cpu")
    x1, x2 = (torch.from_numpy(dp2mp2["inputs"][k][:2]) for k in ("x1", "x2"))
    want = one.step_on(x1, x2)
    ranks = dp2mp2["ranks"]
    for res in ranks:
        np.testing.assert_allclose(res["b2"]["terms"], [t.item() for t in want],
                                   rtol=TERM_RTOL)
    for n, p in ranks[0]["b2"]["params"].items():
        assert torch.equal(p, ranks[2]["b2"]["params"][n]), n
        assert torch.equal(ranks[1]["b2"]["params"][n], ranks[3]["b2"]["params"][n]), n


def test_orbax_four_ranks(dp2mp2):
    """dp 2 x mp 2: column-parallel blocks along their model dim and ZeRO
    moments of those blocks, each chunk written by the lowest rank that
    holds it, restored by dvc_tpu on its 4 x 2 mesh and without."""
    _check_sharded_orbax(dp2mp2["inputs"]["ck2"], dp2mp2["inputs"]["ock"], 4,
                         {"model_parallel": 2})


@pytest.mark.parametrize("scenario", ["dp2mp2", "dp2"])
def test_zero_moment_bytes(scenario, request):
    """With shard_opt_state, a rank keeps 1/dp (dp 2) of the Adam moments
    of exactly the tensors train_state_shardings ZeRO-shards, and all of
    the rest's."""
    res = request.getfixturevalue(scenario)
    key, mp = ("step", 2) if scenario == "dp2mp2" else ("adv", 1)
    zero = pmesh.train_state_shardings(DisentangledVAE(VAEConfig(**SMALL)),
                                       {"data": 2, "model": mp})["opt_state"]
    want = {n for n, pl in zero.items() if isinstance(pl[0], pmesh.Shard)}
    assert want
    for r in res["ranks"]:
        by_name = r[key]["moment_bytes"]
        assert {n for n, (held, whole) in by_name.items() if held < whole} == want
        assert all(2 * by_name[n][0] == by_name[n][1] for n in want)
        assert all(held == whole > 0 for n, (held, whole) in by_name.items() if n not in want)


def test_config_unchanged_by_mesh():
    """MeshConfig gains no field: config.json stays dvc_tpu's."""
    assert [f.name for f in dataclasses.fields(MeshConfig)] == \
        [f.name for f in dataclasses.fields(JC.MeshConfig)]
