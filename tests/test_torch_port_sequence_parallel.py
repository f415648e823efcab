"""The port's frame-axis (sequence) parallelism against dvc_tpu's
parallel/sequence.py on the CPU: on 4 gloo ranks started by
tests/torch_parallel_ranks.py (which imports no jax), the halo-exchange
conv1d for k in {3, 5} and its gradient, the carry-relay LSTM forward and
reversed, and whole_utterance_encode(mesh) over the tiny VAE, each against
dvc_tpu's sharded function on conftest's 8 CPU devices.

On 2 and 4 ranks, in float64 and float32: the gradients of the ring LSTM
(both ways), of frame_sharded_encode_conv_stack and of the whole
frame-sharded encoder (the conv stack and the 2-layer biLSTM) against
jax.grad of dvc_tpu's functions on a mesh of as many CPU devices, and
against the unsharded port in this process; and the inference callers
(whole_utterance_encode(mesh), convert_mel_long_context(mesh)) with no
autograd graph, bit-equal to the autograd path's forward."""

import contextlib
from unittest import mock

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

import dvc_tpu.parallel.sequence as jax_sequence
from dvc_tpu.config import MeshConfig as JaxMeshConfig
from dvc_tpu.config import VAEConfig as JaxVAEConfig
from dvc_tpu.models.long_context import _bilstm as jax_bilstm
from dvc_tpu.models.long_context import whole_utterance_encode as jax_whole_utterance_encode
from dvc_tpu.parallel.mesh import make_mesh
from dvc_tpu.parallel.sequence import (frame_sharded_encode_conv_stack, sequence_sharded_conv1d,
                                       sequence_sharded_lstm)
from dvc_tpu_torch.config import VAEConfig
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.long_context import convert_mel_long_context
from dvc_tpu_torch.utils.convert import vae_state_dict_from_jax
from test_torch_port_parallel import jax_tiny_vae
from test_torch_port_train import SMALL
from torch_parallel_ranks import Ranks

WORLD = 4
# tests/test_sequence_parallel.py's limits: the conv (and here its
# gradient, the same sums transposed), the LSTM, and
# tests/test_long_context.py:54-64's for the whole-utterance encode
CONV_TOL, LSTM_RTOL, LSTM_ATOL = 2e-5, 1e-5, 1e-6
ENC_RTOL, ENC_ATOL = 2e-4, 2e-5
# the gradients, each within this share of its largest element
GRAD_TOL = {"float64": 1e-10, "float32": 1e-4}
WORLDS = (2, 4)


def _conv_inputs(k):
    rng = np.random.RandomState(k)
    return {"x": rng.rand(2, 16, 64).astype(np.float32),          # (B, C, T), T over 4
            "w": (rng.rand(24, 16, k) - 0.5).astype(np.float32),    # (C_out, C_in, k)
            "b": rng.rand(24).astype(np.float32),
            "gy": rng.randn(2, 24, 64).astype(np.float32)}


def _lstm_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 12).astype(np.float32) * 0.2, rng.randn(64, 16).astype(np.float32) * 0.2,
         rng.randn(64).astype(np.float32) * 0.1, rng.randn(64).astype(np.float32) * 0.1)
    return {"x": np.random.RandomState(1).randn(3, 32, 12).astype(np.float32), "w": w}


def _jax_conv(c, mesh):
    """dvc_tpu's shard_map conv on c's inputs (its layout), the output and
    the gradients of sum(y * gy) in the port's layout."""
    x, w, b, gy = (jnp.asarray(a) for a in (c["x"].transpose(0, 2, 1),
                                            c["w"].transpose(2, 1, 0), c["b"],
                                            c["gy"].transpose(0, 2, 1)))

    def loss(x, w, b):
        y = sequence_sharded_conv1d(x, w, b, mesh)
        return jnp.sum(y * gy), y

    (_, y), (dx, dw, db) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, w, b)
    return {"y": np.asarray(y).transpose(0, 2, 1), "dx": np.asarray(dx).transpose(0, 2, 1),
            "dw": np.asarray(dw).transpose(2, 1, 0), "db": np.asarray(db)}


def _grad_inputs() -> dict:
    """The gradient checks' inputs, float64, and the float32 copy of them."""
    rng = np.random.RandomState(5)
    g = {"lstm": {"x": rng.randn(3, 32, 12), "w": [rng.randn(64, 12) * 0.2,
                                                  rng.randn(64, 16) * 0.2,
                                                  rng.randn(64) * 0.1, rng.randn(64) * 0.1],
                  "gy": rng.randn(3, 32, 16), "gh": rng.randn(3, 16), "gc": rng.randn(3, 16)},
         "mel": rng.rand(2, 80, 4 * SMALL["frames"]),
         "g_stack": rng.randn(2, SMALL["enc_channels"], 4 * SMALL["frames"]),
         "g_enc": rng.randn(2, 4 * SMALL["frames"], 2 * SMALL["dim_neck"])}
    return {"float64": g, "float32": jax.tree.map(lambda a: a.astype(np.float32), g)}


@contextlib.contextmanager
def _jax_dtype(name: str):
    """float32 as dvc_tpu runs; float64 with x64 on, and dvc_tpu's ring
    LSTM without its preferred_element_type=float32 (the input projection
    and the recurrence's dot, parallel/sequence.py:93 and :132), which
    would round a float64 run's products to float32."""
    if name == "float32":
        yield
        return

    class _NoFloat32Dot:
        def __getattr__(self, attr):
            return getattr(jnp, attr)

        @staticmethod
        def dot(*a, preferred_element_type=None, **k):
            return jnp.dot(*a, **k)

        @staticmethod
        def einsum(*a, preferred_element_type=None, **k):
            return jnp.einsum(*a, **k)

    with jax.enable_x64(True), mock.patch.object(jax_sequence, "jnp", _NoFloat32Dot()):
        yield


def _enc_port_names(g: dict) -> dict:
    """A gradient of dvc_tpu's encoder subtree under the port's names and
    in its layout."""
    out = {}
    for i in range(3):
        out[f"enc_modules.{i}.0.conv.weight"] = g[f"conv{i}"]["conv"]["kernel"].transpose(2, 1, 0)
        out[f"enc_modules.{i}.0.conv.bias"] = g[f"conv{i}"]["conv"]["bias"]
        out[f"enc_modules.{i}.1.weight"] = g[f"bn{i}"]["bn"]["scale"]
        out[f"enc_modules.{i}.1.bias"] = g[f"bn{i}"]["bn"]["bias"]
    for k, a in g.get("lstm", {}).items():  # w_ih_l0_reverse -> weight_ih_l0_reverse
        kind, rest = k.split("_", 1)
        out[f"enc_lstm.{'weight' if kind == 'w' else 'bias'}_{rest}"] = a
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_grads(g: dict, variables: dict, n: int) -> dict:
    """jax.grad of dvc_tpu's ring LSTM (both ways), conv stack and
    frame-sharded encoder on a mesh of n CPU devices, in g's dtype, the
    results in the port's layout."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    out = {}
    lstm = g["lstm"]
    for rev in (False, True):
        def loss(x, *w):
            y, (h, c) = sequence_sharded_lstm(x, *w, mesh, reverse=rev, unroll=1)
            return jnp.sum(y * lstm["gy"]) + jnp.sum(h * lstm["gh"]) + jnp.sum(c * lstm["gc"])

        dx, *dw = jax.jit(jax.grad(loss, argnums=range(5)))(lstm["x"], *lstm["w"])
        out[f"lstm_{rev}"] = {"dx": np.asarray(dx), "dw": [np.asarray(a) for a in dw]}
    dt = g["mel"].dtype
    enc = jax.tree.map(lambda a: jnp.asarray(a, dt), variables["params"]["encoder"])
    stats = jax.tree.map(lambda a: jnp.asarray(a, dt), variables["batch_stats"]["encoder"])
    stack_p = {k: v for k, v in enc.items() if k[:-1] in ("conv", "bn")}

    def stack(x, p):
        return frame_sharded_encode_conv_stack(x, {"params": p, "batch_stats": stats}, mesh,
                                               eps=JaxVAEConfig().bn_eps)

    def loss_stack(x, p):
        return jnp.sum(stack(x, p) * g["g_stack"].transpose(0, 2, 1))

    def loss_enc(x, p):
        h = jax_bilstm(stack(x, p), p["lstm"], JaxVAEConfig(**SMALL).enc_lstm_layers, mesh)
        return jnp.sum(h * g["g_enc"])

    x = g["mel"].transpose(0, 2, 1)
    for key, fn, p in (("stack", loss_stack, stack_p),
                       ("enc", loss_enc, {**stack_p, "lstm": enc["lstm"]})):
        dx, dp = jax.jit(jax.grad(fn, argnums=(0, 1)))(x, p)
        out[key] = {"dx": np.asarray(dx).transpose(0, 2, 1), "dw": _enc_port_names(dp)}
    return out


def _plain_grads(g: dict, vae_sd: dict) -> dict:
    """The same gradients through the unsharded port in this process:
    nn.LSTM over the whole sequence, the encoder's convs on the whole
    utterance."""
    dt = torch.float64 if g["mel"].dtype == np.float64 else torch.float32
    t = {k: torch.from_numpy(v) for k, v in g["lstm"].items() if k != "w"}
    out = {}
    for rev in (False, True):
        lstm = torch.nn.LSTM(12, 16, batch_first=True).to(dt)
        with torch.no_grad():
            for p, w in zip(lstm.parameters(), g["lstm"]["w"]):
                p.copy_(torch.from_numpy(w))
        x = t["x"].clone().requires_grad_()
        y, (h, c) = lstm(x.flip(1) if rev else x)
        y = y.flip(1) if rev else y
        ((y * t["gy"]).sum() + (h[0] * t["gh"]).sum() + (c[0] * t["gc"]).sum()).backward()
        out[f"lstm_{rev}"] = {"dx": x.grad.numpy(), "dw": [p.grad.numpy() for p in lstm.parameters()]}
    model = DisentangledVAE(VAEConfig(**SMALL))
    model.load_state_dict(vae_sd)
    model.to(dt).eval()

    def stack(x):
        for m in model.enc_modules:
            bn = m[1]
            x = F.relu(F.batch_norm(m[0](x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                    training=False, eps=bn.eps))
        return x

    for key, fn in (("stack", stack), ("enc", lambda x: model.enc_lstm(stack(x).transpose(1, 2))[0])):
        model.zero_grad()
        x = torch.from_numpy(g["mel"]).requires_grad_()
        (fn(x) * torch.from_numpy(g[f"g_{key}"])).sum().backward()
        out[key] = {"dx": x.grad.numpy(), "dw": {n: p.grad.numpy() for n, p in
                                                 model.named_parameters() if p.grad is not None}}
    return out


@pytest.fixture(scope="module")
def seq4(tmp_path_factory):
    """The 4-rank and 2-rank results and dvc_tpu's, computed while the
    ranks run."""
    _, variables = jax_tiny_vae(fused=False, stats_seed=0)
    pm = DisentangledVAE(VAEConfig(**SMALL))
    pm.load_state_dict(vae_state_dict_from_jax(variables["params"], variables["batch_stats"]))
    mel = np.random.RandomState(1).rand(2, 80, 4 * SMALL["frames"]).astype(np.float32)
    inputs = {"conv": {k: _conv_inputs(k) for k in (3, 5)}, "lstm": _lstm_inputs(),
              "vae_cfg": VAEConfig(**SMALL), "vae_sd": pm.state_dict(), "mel": mel,
              "grad": _grad_inputs()}
    ranks = {w: Ranks(f"seq{w}", w, tmp_path_factory.mktemp(f"seq{w}"), inputs) for w in WORLDS}
    mesh = make_mesh(JaxMeshConfig())
    want = {f"conv{k}": _jax_conv(inputs["conv"][k], mesh) for k in (3, 5)}
    lx, lw = jnp.asarray(inputs["lstm"]["x"]), [jnp.asarray(a) for a in inputs["lstm"]["w"]]
    for rev in (False, True):
        y, (h, c) = sequence_sharded_lstm(lx, *lw, mesh, reverse=rev, unroll=1)
        want[f"lstm_{rev}"] = {"y": np.asarray(y), "h": np.asarray(h), "c": np.asarray(c)}
    want["whole"] = [np.asarray(a) for a in jax_whole_utterance_encode(
        JaxVAEConfig(**SMALL), variables, jnp.asarray(mel), mesh)]
    grads = {}
    for name, g in inputs["grad"].items():
        with _jax_dtype(name):
            grads[name] = {w: _jax_grads(g, variables, w) for w in WORLDS}
        grads[name]["plain"] = _plain_grads(g, inputs["vae_sd"])
    convert = convert_mel_long_context(pm.eval(), mel[0], mel[1], SMALL["frames"])
    by_world = {w: r.results() for w, r in ranks.items()}
    return {"ranks": by_world[4], "by_world": by_world, "want": want, "grads": grads,
            "convert": convert}


def _joined(ranks, key, field, axis):
    return np.concatenate([r[key][field].numpy() for r in ranks], axis)


@pytest.mark.parametrize("k", [3, 5])
def test_halo_conv(seq4, k):
    """The output, and the gradients of sum(y * gy) with respect to the
    input (the halos' parts sent back to the neighbours), the kernel and
    the bias (summed over the ranks), against dvc_tpu's shard_map conv."""
    want, ranks = seq4["want"][f"conv{k}"], seq4["ranks"]
    for f in ("y", "dx"):
        np.testing.assert_allclose(_joined(ranks, f"conv{k}", f, 2), want[f], rtol=CONV_TOL,
                                   atol=CONV_TOL * np.abs(want[f]).max())
    for r in ranks:
        for f in ("dw", "db"):
            np.testing.assert_allclose(r[f"conv{k}"][f].numpy(), want[f], rtol=CONV_TOL,
                                       atol=CONV_TOL * np.abs(want[f]).max())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
def test_ring_lstm(seq4, reverse):
    """Each rank's outputs joined, and the final carry on every rank,
    against dvc_tpu's ring-relay LSTM (tests/test_sequence_parallel.py's
    inputs and limits)."""
    key = f"lstm_{reverse}"
    want = seq4["want"][key]
    np.testing.assert_allclose(_joined(seq4["ranks"], key, "y", 1), want["y"],
                               rtol=LSTM_RTOL, atol=LSTM_ATOL)
    for r in seq4["ranks"]:
        for f in ("h", "c"):
            np.testing.assert_allclose(r[key][f].numpy(), want[f], rtol=LSTM_RTOL,
                                       atol=LSTM_ATOL)


def test_whole_utterance_encode_mesh(seq4):
    """whole_utterance_encode over 4 ranks (4 chunks of 16 frames) against
    dvc_tpu's on its 8-device mesh; every rank returns the whole result."""
    for r in seq4["ranks"]:
        for g, w in zip(r["whole"], seq4["want"]["whole"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=ENC_RTOL, atol=ENC_ATOL)


def _close(got, want, dtype, what):
    tol = GRAD_TOL[dtype] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _check_grads(seq, world, dtype, key, axis, names):
    """Each rank's gradients of ``key`` against jax.grad of dvc_tpu's
    function on a mesh of ``world`` devices and against the unsharded port:
    the input's joined over the ranks (along ``axis``), each weight's on
    every rank."""
    ranks = seq["by_world"][world]
    got_dx = np.concatenate([r["grad"][dtype][key]["dx"].numpy() for r in ranks], axis)
    for ref in (seq["grads"][dtype][world][key], seq["grads"][dtype]["plain"][key]):
        _close(got_dx, ref["dx"], dtype, f"{key} input gradient")
        for r in ranks:
            dw = r["grad"][dtype][key]["dw"]
            pairs = (zip(names, dw, ref["dw"]) if isinstance(dw, list)
                     else ((n, dw[n], ref["dw"][n]) for n in names))
            for n, a, b in pairs:
                assert a.dtype == getattr(torch, dtype)
                _close(a.numpy(), b, dtype, f"{key} {n} gradient")


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_lstm_grad(seq4, world, dtype, reverse):
    """The ring LSTM's input and weight gradients (outputs' loss and the
    final carry's) on 2 and 4 ranks: the carry's gradient relayed back
    along the ring, the weights' summed over the ranks."""
    _check_grads(seq4, world, dtype, f"lstm_{reverse}", 1,
                 ["weight_ih", "weight_hh", "bias_ih", "bias_hh"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("world", WORLDS)
def test_conv_stack_grad(seq4, world, dtype):
    """frame_sharded_encode_conv_stack's input gradient and every conv and
    BatchNorm weight's (BatchNorm's scale and bias summed over the
    ranks)."""
    names = sorted(seq4["grads"][dtype]["plain"]["stack"]["dw"])
    assert len(names) == 12
    _check_grads(seq4, world, dtype, "stack", 2, names)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("world", WORLDS)
def test_frame_sharded_encoder_grad(seq4, world, dtype):
    """The whole frame-sharded encoder, the conv stack and both directions
    of both biLSTM layers, its input and every weight gradient."""
    names = sorted(seq4["grads"][dtype]["plain"]["enc"]["dw"])
    assert len(names) == 12 + 16
    _check_grads(seq4, world, dtype, "enc", 2, names)


@pytest.mark.parametrize("world", WORLDS)
def test_inference_callers_unchanged(seq4, world):
    """whole_utterance_encode(mesh) and convert_mel_long_context(mesh) run
    under inference_mode: their outputs carry no autograd graph, the
    frame-sharded encode is bit-equal to the same ranks' autograd path
    (the ring's autograd Function) and the same on every rank, and the
    conversion matches the unsharded one's."""
    ranks = seq4["by_world"][world]
    for r in ranks:
        assert not any(r["graphs"]) and r["autograd_path"]
        assert torch.equal(r["h_inf"], r["h_grad"])
        for a, b in zip(r["whole"], ranks[0]["whole"]):
            assert torch.equal(a, b)
        for g, w in zip(r["convert"], seq4["convert"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=ENC_RTOL, atol=ENC_ATOL)
    for g, w in zip(ranks[0]["whole"], seq4["want"]["whole"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=ENC_RTOL, atol=ENC_ATOL)
