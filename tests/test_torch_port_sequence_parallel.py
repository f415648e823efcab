"""The port's frame-axis (sequence) parallelism against dvc_tpu's
parallel/sequence.py on the CPU: on 4 gloo ranks started by
tests/torch_parallel_ranks.py (which imports no jax), the halo-exchange
conv1d for k in {3, 5} and its gradient, the carry-relay LSTM forward and
reversed, and whole_utterance_encode(mesh) over the tiny VAE, each against
dvc_tpu's sharded function on conftest's 8 CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvc_tpu.config import MeshConfig as JaxMeshConfig
from dvc_tpu.config import VAEConfig as JaxVAEConfig
from dvc_tpu.models.long_context import whole_utterance_encode as jax_whole_utterance_encode
from dvc_tpu.parallel.mesh import make_mesh
from dvc_tpu.parallel.sequence import sequence_sharded_conv1d, sequence_sharded_lstm
from dvc_tpu_torch.config import VAEConfig
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
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


@pytest.fixture(scope="module")
def seq4(tmp_path_factory):
    """The 4-rank results and dvc_tpu's, computed while the ranks run."""
    _, variables = jax_tiny_vae(fused=False, stats_seed=0)
    pm = DisentangledVAE(VAEConfig(**SMALL))
    pm.load_state_dict(vae_state_dict_from_jax(variables["params"], variables["batch_stats"]))
    mel = np.random.RandomState(1).rand(2, 80, 4 * SMALL["frames"]).astype(np.float32)
    inputs = {"conv": {k: _conv_inputs(k) for k in (3, 5)}, "lstm": _lstm_inputs(),
              "vae_cfg": VAEConfig(**SMALL), "vae_sd": pm.state_dict(), "mel": mel}
    ranks = Ranks("seq4", WORLD, tmp_path_factory.mktemp("seq4"), inputs)
    mesh = make_mesh(JaxMeshConfig())
    want = {f"conv{k}": _jax_conv(inputs["conv"][k], mesh) for k in (3, 5)}
    lx, lw = jnp.asarray(inputs["lstm"]["x"]), [jnp.asarray(a) for a in inputs["lstm"]["w"]]
    for rev in (False, True):
        y, (h, c) = sequence_sharded_lstm(lx, *lw, mesh, reverse=rev, unroll=1)
        want[f"lstm_{rev}"] = {"y": np.asarray(y), "h": np.asarray(h), "c": np.asarray(c)}
    want["whole"] = [np.asarray(a) for a in jax_whole_utterance_encode(
        JaxVAEConfig(**SMALL), variables, jnp.asarray(mel), mesh)]
    return {"ranks": ranks.results(), "want": want}


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
