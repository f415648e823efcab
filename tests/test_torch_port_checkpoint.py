"""Checkpoints cross between the packages: the port's msgpack reader and
writer against flax.serialization, dvc_tpu's TrainState .msgpack loaded and
resumed in the port, the port's .msgpack restored by dvc_tpu's
load_last_checkpoint, discovery across .pth and .msgpack, orbax refused,
and dvc_tpu's msgpack vocoder read by the port.

The same seeded weights go to both packages.  Weights, BatchNorm
statistics, Adam's moments and the step cross as float32 and int32 bits,
so they are held equal; a conversion through the loaded weights is held at
the full-VAE gate of tests/test_torch_parity.py:234-244 (1e-3/1e-4)."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.convert import conversion as jconv
from dvc_tpu.convert.vocode import load_vocoder_params as jax_load_vocoder_params
from dvc_tpu.models.wavenet import WaveNet as JaxWaveNet
from dvc_tpu.train import checkpoint as jckpt
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu.train.trainer import TrainState
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import Config, TrainConfig, VAEConfig, VocoderConfig
from dvc_tpu_torch.convert import conversion
from dvc_tpu_torch.convert.vocode import load_vocoder_params
from dvc_tpu_torch.data.dataset import PairedMelDataset
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.wavenet import WaveNet
from dvc_tpu_torch.train import checkpoint as ckpt
from dvc_tpu_torch.train.trainer import Trainer
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import (vae_state_dict_from_jax, vae_tree_from_state_dict,
                                         wavenet_state_dict_from_jax,
                                         wavenet_tree_from_state_dict)

SMALL = dict(frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
             dec_lstm2_hidden=32, postnet_channels=32)
FULL_RTOL, FULL_ATOL = 1e-3, 1e-4
TINY_VOC = dict(layers=4, stacks=2, residual_channels=8, gate_channels=8,
                skip_out_channels=8)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _assert_trees_equal(got, want, where=""):
    assert isinstance(got, dict) and isinstance(want, dict), where
    assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (where, k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{where}/{k}")


def _mel_tree(root, speakers=("p225", "p226"), utts=4, t_range=(20, 40), seed=0):
    rng = np.random.RandomState(seed)
    for spk in speakers:
        d = os.path.join(root, spk)
        os.makedirs(d, exist_ok=True)
        for u in range(utts):
            np.save(os.path.join(d, f"{spk}_{u:03d}_mel.npy"),
                    rng.rand(80, rng.randint(*t_range)).astype(np.float32))


# --- the msgpack codec -------------------------------------------------------

def _codec_cases():
    rng = np.random.RandomState(0)
    return {
        "scalars": {"none": None, "t": True, "f": False, "ints": [0, 127, 128, 255, 256, 65535,
                    65536, 2**32 - 1, 2**32, 2**63 - 1, -1, -32, -33, -128, -129, -32768,
                    -32769, -2**31, -2**31 - 1, -2**63], "floats": [0.0, -1.5, 1e300]},
        "strings": {"": "", "short": "s" * 31, "str8": "é" * 100, "str16": "x" * 300,
                    "bin8": b"\x00" * 10, "bin16": b"\x01" * 70000, "list": [1, "a", None]},
        "containers": {"fixmap": {str(i): i for i in range(15)},
                       "map16": {str(i): [i] * 16 for i in range(16)},
                       "empty": {}, "nested": {"a": {"b": {"c": []}}}},
        "arrays": {"f32": rng.randn(3, 4).astype(np.float32),
                   "i32_0d": np.array(7, np.int32), "f64": rng.randn(5),
                   "i8": np.arange(-4, 4, dtype=np.int8), "u8_fixext": np.arange(2, dtype=np.uint8),
                   "f16": rng.randn(2, 2).astype(np.float16), "empty": np.zeros((0, 3), np.float32),
                   "bool": np.array([True, False]), "big": rng.randn(70000).astype(np.float32),
                   "np_scalars": [np.float32(2.5), np.int64(-3), np.uint16(9)]},
    }


@pytest.mark.parametrize("case", sorted(_codec_cases()))
def test_msgpack_codec_against_flax(case):
    """packb gives flax's bytes for the same tree (in place, so dicts keep
    their order); unpackb reads flax's bytes to the same tree and types."""
    tree = _codec_cases()[case]
    want = serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    assert msgpack.packb(tree) == want
    got = msgpack.unpackb(want)
    ref = serialization.msgpack_restore(want)
    leaves_g, tdef_g = jax.tree_util.tree_flatten(got, is_leaf=lambda x: x is None)
    leaves_r, tdef_r = jax.tree_util.tree_flatten(ref, is_leaf=lambda x: x is None)
    assert tdef_g == tdef_r
    for g, r in zip(leaves_g, leaves_r):
        assert type(g) is type(r), (type(g), type(r))
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r


def test_msgpack_refuses_what_flax_cannot_read():
    with pytest.raises(TypeError):
        msgpack.packb({1: 2})
    with pytest.raises(TypeError):
        msgpack.packb({"a": object()})
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(msgpack.packb({"a": np.ones(9)})[:-3])


# --- the VAE TrainState --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """A dvc_tpu TrainState at step 3 with non-trivial BatchNorm statistics
    and Adam moments (three optax.adam updates on seeded gradients)."""
    cfg = JC.Config(vae=JC.VAEConfig(**SMALL), train=JC.TrainConfig(batch_size=2))
    trainer = JaxTrainer(cfg, use_mesh=False)
    st = trainer.state
    rng = np.random.RandomState(0)
    params = st.params
    opt_state = st.opt_state
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
        updates, opt_state = trainer.optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    stats = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32)),
        st.batch_stats)
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=params, batch_stats=stats,
                       opt_state=opt_state)
    return cfg, trainer, state


def _port_config(**train_kw):
    return Config(vae=VAEConfig(**SMALL), train=TrainConfig(
        batch_size=2, compute_dtype="float32", **train_kw))


def test_vae_tree_round_trip(jax_state):
    """dvc_tpu tree -> port state dict -> dvc_tpu tree, bit for bit, keys
    and all."""
    _, _, state = jax_state
    params, stats = _np_tree(state.params), _np_tree(state.batch_stats)
    p2, s2 = vae_tree_from_state_dict(vae_state_dict_from_jax(params, stats))
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, stats)


def test_dvc_tpu_train_state_loads_in_port(jax_state, tmp_path):
    """A TrainState that dvc_tpu's Trainer.save wrote: the port's Trainer
    resumes from it (weights, BN statistics, Adam moments, step) and the
    loaded model converts to dvc_tpu's mels."""
    cfg, trainer, state = jax_state
    jt = copy.copy(trainer)
    jt.checkpoints_path = str(tmp_path)
    jt.state = state
    path = jt.save(5)
    assert path.endswith("DisentangledVAE_VCTK_5.msgpack")

    pt = Trainer(_port_config(), checkpoints_path=str(tmp_path), device="cpu")
    assert pt.load_last() == 6 and pt.step == 3
    params, stats = vae_tree_from_state_dict(pt.model.state_dict())
    _assert_trees_equal(params, _np_tree(state.params))
    _assert_trees_equal(stats, _np_tree(state.batch_stats))
    adam = state.opt_state[0]
    opt = pt.optimizer.state_dict()["state"]
    names = [n for n, _ in pt.model.named_parameters()]
    mu = {n: opt[i]["exp_avg"] for i, n in enumerate(names)}
    nu = {n: opt[i]["exp_avg_sq"] for i, n in enumerate(names)}
    _assert_trees_equal(vae_tree_from_state_dict(mu)[0], _np_tree(adam.mu))
    _assert_trees_equal(vae_tree_from_state_dict(nu)[0], _np_tree(adam.nu))
    assert all(float(s["step"]) == 3.0 for s in opt.values())

    model = DisentangledVAE(VAEConfig(**SMALL))
    assert ckpt.load_last_checkpoint(str(tmp_path), model) == 5
    model.eval()
    rng = np.random.RandomState(2)
    src = rng.rand(80, 40).astype(np.float32)
    trg = rng.rand(80, 33).astype(np.float32)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = jconv.convert_mel(trainer.model, variables, src, trg, SMALL["frames"])
    got = conversion.convert_mel(model, src, trg, SMALL["frames"])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=FULL_RTOL, atol=FULL_ATOL)


def test_port_msgpack_restores_in_dvc_tpu(jax_state, tmp_path):
    """The port trains two epochs and saves; dvc_tpu's load_last_checkpoint
    restores the .msgpack into its own TrainState: params, batch_stats,
    Adam's mu/nu and count, and the step are the port's.  Its bytes are
    what flax's to_bytes writes for the restored state once it has been
    through jax (a trained state's dicts, which jax's flattening sorts)."""
    cfg, trainer, _ = jax_state
    _mel_tree(str(tmp_path / "mels"))
    ck = str(tmp_path / "ck")
    pt = Trainer(_port_config(), checkpoints_path=ck, device="cpu")
    pt.run_training(PairedMelDataset(str(tmp_path / "mels"), samples_length=16, seed=0), 2,
                    report_interval=2, logging_func=lambda *a: None)
    assert sorted(os.listdir(ck)) == [f"DisentangledVAE_VCTK_2{s}"
                                      for s in (".msgpack", ".opt.pth", ".pth")]
    epoch, restored = jckpt.load_last_checkpoint(ck, trainer.state)
    assert epoch == 2 and int(restored.step) == pt.step > 0
    params, stats = vae_tree_from_state_dict(pt.model.state_dict())
    _assert_trees_equal(_np_tree(restored.params), params)
    _assert_trees_equal(_np_tree(restored.batch_stats), stats)
    names = [n for n, _ in pt.model.named_parameters()]
    opt = pt.optimizer.state_dict()["state"]
    adam = restored.opt_state[0]
    assert int(adam.count) == pt.step
    _assert_trees_equal(_np_tree(adam.mu),
                        vae_tree_from_state_dict({n: opt[i]["exp_avg"]
                                                  for i, n in enumerate(names)})[0])
    _assert_trees_equal(_np_tree(adam.nu),
                        vae_tree_from_state_dict({n: opt[i]["exp_avg_sq"]
                                                  for i, n in enumerate(names)})[0])
    with open(os.path.join(ck, "DisentangledVAE_VCTK_2.msgpack"), "rb") as f:
        assert f.read() == serialization.to_bytes(jax.tree_util.tree_map(np.asarray, restored))

    # the .msgpack alone resumes the port as the .pth pair does
    alone = tmp_path / "alone"
    alone.mkdir()
    os.replace(os.path.join(ck, "DisentangledVAE_VCTK_2.msgpack"),
               alone / "DisentangledVAE_VCTK_2.msgpack")
    a = Trainer(_port_config(), checkpoints_path=str(alone), device="cpu")
    b = Trainer(_port_config(), checkpoints_path=ck, device="cpu")
    assert a.load_last() == b.load_last() == 3 and a.step == b.step == pt.step
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for k in sb:
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][f], sb[k][f]), (k, f)


def _touch_checkpoint(path, model, t):
    if path.endswith(".msgpack"):
        with open(path, "wb") as f:
            f.write(msgpack.packb(ckpt.train_state_tree(model, None, 0)))
    elif path.endswith(".orbax"):
        os.makedirs(path)
    else:
        torch.save(model.state_dict(), path)
    os.utime(path, ns=(t, t))


@pytest.mark.parametrize("files,want", [
    ((("_2.pth", 1), ("_3.msgpack", 2)), "_3.msgpack"),
    ((("_10.msgpack", 1), ("_9.pth", 2)), "_10.msgpack"),
    ((("_4.msgpack", 2), ("_4.pth", 1)), "_4.msgpack"),   # a tie: the newer file
    ((("_4.msgpack", 1), ("_4.pth", 1)), "_4.pth"),       # same time: save's last
    ((("_4.opt.pth", 5), ("_3.pth", 1)), "_3.pth"),
], ids=["msgpack-newer-epoch", "pth-older-epoch", "tie-newer", "tie-same-time",
        "opt-skipped"])
def test_discovery_newest_epoch_across_formats(tmp_path, files, want):
    model = DisentangledVAE(VAEConfig(**SMALL))
    for sfx, t in files:
        _touch_checkpoint(str(tmp_path / f"DisentangledVAE_VCTK{sfx}"), model, t * 10**9)
    epoch, path = ckpt.latest_checkpoint_step(str(tmp_path))
    assert os.path.basename(path) == f"DisentangledVAE_VCTK{want}"
    assert epoch == int(want[1:].split(".")[0])
    # dvc_tpu agrees wherever it can see the files
    if want.endswith(".msgpack"):
        assert jckpt.latest_checkpoint_step(str(tmp_path))[1] == path


def test_orbax_refused(tmp_path):
    """Orbax is a format like msgpack now: a newest .orbax checkpoint is
    what load_last_checkpoint loads, save_checkpoint(fmt="orbax") writes
    the .orbax beside the .pth pair, and only an unknown format is refused
    (by save_checkpoint and by the CLI's choices)."""
    model = DisentangledVAE(VAEConfig(**SMALL))
    _touch_checkpoint(str(tmp_path / "DisentangledVAE_VCTK_1.pth"), model, 10**9)
    other = DisentangledVAE(VAEConfig(**SMALL))
    with torch.no_grad():
        for p in other.parameters():
            p.add_(1.0)
    ckpt.save_checkpoint(str(tmp_path / "o"), "DisentangledVAE_VCTK", 2, other, fmt="orbax")
    os.rename(tmp_path / "o" / "DisentangledVAE_VCTK_2.orbax",
              tmp_path / "DisentangledVAE_VCTK_2.orbax")
    assert sorted(os.listdir(tmp_path / "o")) == ["DisentangledVAE_VCTK_2.pth"]
    assert ckpt.load_last_checkpoint(str(tmp_path), model) == 2
    for (n, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert n.endswith("num_batches_tracked") or torch.equal(a, b), n
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        ckpt.save_checkpoint(str(tmp_path), "x", 1, model, fmt="zip")
    with pytest.raises(SystemExit):
        cli.main(["train", "--dataset_fp", str(tmp_path), "--log_dir", str(tmp_path),
                  "--checkpoint-format", "zip", "--device", "cpu"])


# --- the vocoder ---------------------------------------------------------------

def test_msgpack_vocoder_loads_as_the_pth_route(tmp_path):
    """dvc_tpu's msgpack vocoder tree loads to the weights that the .pth
    route gives for the same WaveNet, and loads into the port's WaveNet;
    the port's writer makes a file dvc_tpu's loader reads back."""
    jcfg = JC.VocoderConfig(**TINY_VOC)
    jm = JaxWaveNet(jcfg)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4 * 256, 1)), jnp.zeros((1, 4, 80)))
    params = _np_tree(v["params"])
    msg = tmp_path / "voc.msgpack"
    msg.write_bytes(serialization.to_bytes({"params": v["params"]}))
    pth = tmp_path / "voc.pth"
    torch.save(wavenet_state_dict_from_jax(params), pth)
    got, want = load_vocoder_params(str(msg)), load_vocoder_params(str(pth))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    WaveNet(VocoderConfig(**TINY_VOC)).load_state_dict(got)  # strict

    _assert_trees_equal(wavenet_tree_from_state_dict(got), params)
    ours = tmp_path / "ours.msgpack"
    ours.write_bytes(msgpack.packb({"params": wavenet_tree_from_state_dict(got)}))
    back = jax_load_vocoder_params(str(ours), jcfg)
    _assert_trees_equal(_np_tree(back["params"]), params)
    with pytest.raises(ValueError, match="params"):
        (tmp_path / "bad.msgpack").write_bytes(msgpack.packb({"x": 1}))
        load_vocoder_params(str(tmp_path / "bad.msgpack"))
