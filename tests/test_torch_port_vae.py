"""Port parity of the DisentangledVAE serving surface: the weight bridge,
encode/decode/postnet in eval mode, convert_mel (plain and FS-masked swap)
and VoiceConverter, each against dvc_tpu on the same weights and inputs."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.config import Config as JaxConfig
from dvc_tpu.config import VAEConfig as JaxVAEConfig
from dvc_tpu.convert import conversion as jconv
from dvc_tpu.models.disentangled_vae import DisentangledVAE as JaxVAE
from dvc_tpu.utils.torch_convert import convert_disentangled_vae
from dvc_tpu_torch.config import Config, VAEConfig
from dvc_tpu_torch.convert import conversion
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.utils.convert import vae_state_dict_from_jax

SMALL = dict(frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
             dec_lstm2_hidden=32, postnet_channels=32)
# per-method gate of tests/test_torch_parity.py:27; the full-VAE gate :234-244
RTOL, ATOL = 2e-4, 2e-5
FULL_RTOL, FULL_ATOL = 1e-3, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, port model) sharing one set of weights,
    with non-trivial BatchNorm running statistics."""
    jm = JaxVAE(JaxVAEConfig(**SMALL))
    x = jnp.zeros((2, 80, SMALL["frames"]), jnp.float32)
    key = jax.random.PRNGKey(0)
    v = jm.init({"params": key, "reparam": key}, x, x, train=True)
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    rng = np.random.RandomState(0)
    for grp in stats.values():
        for bn in grp.values():
            shape = bn["bn"]["mean"].shape
            bn["bn"]["mean"] = rng.normal(0, 0.1, shape).astype(np.float32)
            bn["bn"]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    pm = DisentangledVAE(VAEConfig(**SMALL)).eval()
    pm.load_state_dict(vae_state_dict_from_jax(params, stats))  # strict
    return jm, variables, pm


def test_bridge_round_trip(pair):
    """jax tree -> port state dict -> dvc_tpu's own torch->jax converter
    gives back the same tree, bit for bit."""
    _, variables, pm = pair
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    params, stats = convert_disentangled_vae(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
    for path, a in jax.tree_util.tree_leaves_with_path(variables["batch_stats"]):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(stats))[path], a)


def test_encode_decode_postnet(pair):
    jm, variables, pm = pair
    rng = np.random.RandomState(1)
    x = rng.rand(3, 80, SMALL["frames"]).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)

    z = rng.randn(3, 32).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(z), method="decode")
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    want = jm.apply(variables, jnp.asarray(x), method="postnet")
    with torch.no_grad():
        got = pm.postnet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_convert_mel(pair, masked):
    jm, variables, pm = pair
    rng = np.random.RandomState(2)
    src = rng.rand(80, 40).astype(np.float32)
    trg = rng.rand(80, 33).astype(np.float32)
    mask = None
    if masked:
        mask = conversion.binarize_fs_mask(rng.rand(32), 4, top_k=5)
    want = jconv.convert_mel(jm, variables, src, trg, SMALL["frames"], fs_mask=mask)
    got = conversion.convert_mel(pm, src, trg, SMALL["frames"], fs_mask=mask)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (80, (40 // 16 + 1) * 16)
        np.testing.assert_allclose(g, w, rtol=FULL_RTOL, atol=FULL_ATOL)


def test_binarize_fs_mask_and_profile_transfer():
    rng = np.random.RandomState(4)
    for top_k in (None, 0, 3, 40):
        raw = rng.rand(32).astype(np.float32)
        np.testing.assert_array_equal(conversion.binarize_fs_mask(raw, 4, 0.4, top_k),
                                      jconv.binarize_fs_mask(raw, 4, 0.4, top_k))
    src, a, b = rng.rand(80, 20), rng.rand(80), rng.rand(80)
    np.testing.assert_array_equal(conversion.profile_transfer_mel(src, a, b),
                                  jconv.profile_transfer_mel(src, a, b))


def test_voice_converter_pair(pair, tmp_path):
    """Directory runner vs dvc_tpu's, chunked and with --long_context; the
    target dir holds one utterance, since dvc_tpu globs target files
    unsorted."""
    jm, variables, pm = pair
    rng = np.random.RandomState(5)
    for spk, n in (("p1", 3), ("p2", 1)):
        (tmp_path / spk).mkdir()
        for i in range(n):
            np.save(tmp_path / spk / f"{spk}_{i:03d}_mel.npy",
                    rng.rand(80, 20 + 7 * i).astype(np.float32))
    for long_context in (False, True):
        want = jconv.VoiceConverter(JaxConfig(vae=JaxVAEConfig(**SMALL)), jm, variables,
                                    seed=3, long_context=long_context).convert_speaker_pair(
            str(tmp_path), "p1", "p2", str(tmp_path / "gen_jax"), 2, save_png=False)
        got = conversion.VoiceConverter(Config(vae=VAEConfig(**SMALL)), pm, seed=3,
                                        long_context=long_context).convert_speaker_pair(
            str(tmp_path), "p1", "p2", str(tmp_path / "gen_port"), 2, save_png=False)
        assert [w[0] for w in want] == [g[0] for g in got] == ["000", "001"]
        for w, g in zip(want, got):
            np.testing.assert_allclose(g[1], w[1], rtol=FULL_RTOL, atol=FULL_ATOL)
            np.testing.assert_allclose(g[2], w[2], rtol=FULL_RTOL, atol=FULL_ATOL)
