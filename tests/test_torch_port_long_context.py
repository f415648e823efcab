"""Whole-utterance (long-context) encoding of the port against dvc_tpu on the
CPU, at the tiny widths of tests/test_train.py (frames 16): one chunk is
``encode``, a ragged and an exact-multiple length against dvc_tpu's
whole_utterance_encode (chunk counts included), context crossing chunk
boundaries, convert_mel_long_context against dvc_tpu's, and the flags it
cannot be combined with."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.models import long_context as jlc
from dvc_tpu_torch.config import Config, VAEConfig
from dvc_tpu_torch.convert import conversion
from dvc_tpu_torch.models import long_context as lc
from dvc_tpu_torch.parallel.mesh import Mesh
from test_torch_port_vae import ATOL, FULL_ATOL, FULL_RTOL, RTOL, SMALL, pair  # noqa: F401

F = SMALL["frames"]
CFG = VAEConfig(**SMALL)


def test_one_chunk_is_encode(pair):
    """At T == frames the per-chunk posteriors are encode's in eval mode."""
    _, _, pm = pair
    mel = np.random.RandomState(0).rand(3, 80, F).astype(np.float32)
    got = lc.whole_utterance_encode(CFG, pm, mel)
    with torch.no_grad():
        want = pm.encode(torch.from_numpy(mel))
    for g, w in zip(got, want):
        assert g.shape == (3, 1) + w.shape[1:]
        np.testing.assert_allclose(g[:, 0].numpy(), w.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [3 * F + 5, 3 * F], ids=["ragged", "exact_multiple"])
def test_against_dvc_tpu(pair, t):
    """A ragged length pads up to the next chunk; an exact multiple gets
    exactly T / frames chunks, no all-zero extra one."""
    jm, variables, pm = pair
    mel = np.random.RandomState(t).rand(2, 80, t).astype(np.float32)
    want = jlc.whole_utterance_encode(jm.cfg, variables, jnp.asarray(mel))
    got = lc.whole_utterance_encode(CFG, pm, mel)
    n_chunks = -(-t // F)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[:2] == (2, n_chunks)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_context_crosses_chunk_boundaries(pair):
    """Changing chunk 1 moves chunk 2's latents (the biLSTM carries it);
    chunk-by-chunk encoding would leave chunk 2 as it was."""
    _, _, pm = pair
    rng = np.random.RandomState(3)
    mel = rng.rand(1, 80, 4 * F).astype(np.float32)
    edited = mel.copy()
    edited[:, :, F:2 * F] = rng.rand(1, 80, F)
    a = lc.whole_utterance_encode(CFG, pm, mel)[2]
    b = lc.whole_utterance_encode(CFG, pm, edited)[2]
    assert (a[0, 2] - b[0, 2]).abs().max().item() > 1e-4
    with torch.no_grad():
        chunked = [pm.encode(torch.from_numpy(m[:, :, 2 * F:3 * F]))[2] for m in (mel, edited)]
    assert torch.equal(*chunked)


def test_convert_mel_long_context(pair):
    """(recons, converted) against dvc_tpu's on a ragged source and an
    exact-multiple target, at the full-VAE tolerance."""
    jm, variables, pm = pair
    rng = np.random.RandomState(4)
    src = rng.rand(80, 2 * F + 7).astype(np.float32)
    trg = rng.rand(80, 2 * F).astype(np.float32)
    want = jlc.convert_mel_long_context(jm, variables, src, trg, F)
    got = lc.convert_mel_long_context(pm, src, trg, F)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (80, 3 * F)
        np.testing.assert_allclose(g, w, rtol=FULL_RTOL, atol=FULL_ATOL)
    assert 0.0 <= got[1].min() and got[1].max() <= 1.0
    with pytest.raises(ValueError, match="frames"):
        lc.convert_mel_long_context(pm, src, trg, 2 * F)


def test_refused_combinations(pair, tmp_path):
    """--long_context with --fs_mask and with --profile_transfer raise
    dvc_tpu's ValueErrors; so does a mesh whose size does not divide the
    padded frame count (the frame-sharded encode itself is held to dvc_tpu
    on four ranks by test_torch_port_sequence_parallel.py)."""
    _, _, pm = pair
    for spk in ("p1", "p2"):
        (tmp_path / spk).mkdir()
        np.save(tmp_path / spk / f"{spk}_000_mel.npy", np.random.rand(80, 20).astype(np.float32))
    cfg = Config(vae=CFG)
    with pytest.raises(ValueError, match="--fs_mask is not supported with --long_context"):
        conversion.VoiceConverter(cfg, pm, long_context=True, fs_mask=np.ones(32, np.float32)
                                  ).convert_speaker_pair(str(tmp_path), "p1", "p2",
                                                         str(tmp_path / "gen"), 1)
    with pytest.raises(ValueError, match="--profile_transfer"):
        conversion.VoiceConverter(cfg, None, long_context=True, profile_transfer=True
                                  ).convert_speaker_pair(str(tmp_path), "p1", "p2",
                                                         str(tmp_path / "gen"), 1)
    three = Mesh(("data", "model"), 3, 1, 0, 0, None, None, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the 3-device mesh"):
        lc.whole_utterance_encode(CFG, pm, np.zeros((1, 80, F), np.float32), mesh=three)
