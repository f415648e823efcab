"""The rest of dvc_tpu's surface in the port against dvc_tpu on the CPU, as
dvc_tpu's own tests hold it: the group-evidence ops (tests/test_eval.py),
debug_nans (tests/test_utils.py), the reference-checkpoint
parity harness on tools/gen_parity_ckpt.py's full-size fixture
(tests/test_parity_fixture.py), the config presets, the mel extractor's
"auto" backend and content_sensitivity.

Limits (measured in brackets): the group posterior within 1e-6 relative
of dvc_tpu's and 1e-4 of the reference's dict loop (test_eval.py's);
parity_report's numbers within 1e-4 relative of dvc_tpu's (equal), the
same crops and utterances; the mels of "auto" equal to the backend it
picks; content_sensitivity equal.
"""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu import config as JC
from dvc_tpu.convert.conversion import content_sensitivity as jax_content_sensitivity
from dvc_tpu.eval.parity import parity_report as jax_parity_report
from dvc_tpu.ops import group as jgroup
from dvc_tpu_torch import config as PC
from dvc_tpu_torch.convert.conversion import content_sensitivity, profile_transfer_mel
from dvc_tpu_torch.data.preprocess import BatchedMelExtractor
from dvc_tpu_torch.eval.parity import (load_reference_checkpoint, mel_reconstruction_error,
                                       parity_report)
from dvc_tpu_torch.ops import group
from dvc_tpu_torch.utils import profiling


# --- ops/group.py ---------------------------------------------------------------

def test_accumulate_group_evidence():
    rng = np.random.RandomState(0)
    b, d, g = 8, 5, 3
    mu = rng.randn(b, d).astype(np.float32)
    logvar = (rng.randn(b, d) * 0.3).astype(np.float32)
    labels = rng.randint(0, g, b)
    gm, glv = (x.numpy() for x in group.accumulate_group_evidence(
        torch.from_numpy(mu), torch.from_numpy(logvar), torch.from_numpy(labels), g))
    jm, jlv = jgroup.accumulate_group_evidence(jnp.asarray(mu), jnp.asarray(logvar),
                                               jnp.asarray(labels), g)
    np.testing.assert_allclose(gm, np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(glv, np.asarray(jlv), rtol=1e-6, atol=1e-7)
    var = np.exp(logvar)  # the reference's dict loop (model/utils.py:13-75)
    for lab in range(g):
        idx = np.where(labels == lab)[0]
        if len(idx) == 0:
            continue
        gv = 1.0 / (1.0 / var[idx]).sum(axis=0)
        for i in idx:
            np.testing.assert_allclose(gm[i], (mu[idx] / var[idx]).sum(axis=0) * gv, rtol=1e-4)
            np.testing.assert_allclose(glv[i], np.log(gv), rtol=1e-4)


def test_group_wise_reparameterize_and_permute_dims():
    mu, logvar = torch.zeros(4, 3), torch.zeros(4, 3)
    labels = torch.tensor([0, 0, 1, 1])
    z = group.group_wise_reparameterize(torch.Generator().manual_seed(0), mu, logvar, labels, 2)
    assert torch.equal(z[0], z[1]) and torch.equal(z[2], z[3]) and not torch.equal(z[0], z[2])
    again = group.group_wise_reparameterize(torch.Generator().manual_seed(0), mu, logvar,
                                            labels, 2)
    assert torch.equal(z, again)
    # eps ~ N(0, 0.1): the draws scaled by eps_std, shifted by mu
    eps = 0.1 * torch.randn((2, 3), generator=torch.Generator().manual_seed(0))
    assert torch.allclose(z, eps[labels])
    assert torch.equal(group.group_wise_reparameterize(None, mu + 1, logvar, labels, 2,
                                                       train=False), mu + 1)
    zz = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    p = group.permute_dims(torch.Generator().manual_seed(0), zz)
    for j in range(4):
        assert sorted(p[:, j].tolist()) == sorted(zz[:, j].tolist())
    assert not torch.equal(p, zz)


# --- utils/profiling.py -----------------------------------------------------------

def test_debug_nans():
    x = torch.tensor([-1.0], requires_grad=True)
    with profiling.debug_nans():
        with pytest.raises(RuntimeError, match="nan|NaN"):
            torch.sqrt(x).backward()
    with profiling.debug_nans(False):
        torch.sqrt(torch.tensor([-1.0], requires_grad=True)).backward()  # no raise


# --- eval/parity.py ----------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_ckpt(tmp_path_factory):
    from tools.gen_parity_ckpt import build_vae_module
    out = tmp_path_factory.mktemp("ckpts")
    path = str(out / "DisentangledVAE_VCTK_fixture_100.pth")
    torch.save(build_vae_module().state_dict(), path)
    mels = out / "mels"
    rng = np.random.RandomState(0)
    for spk in ("p225", "p226"):
        (mels / spk).mkdir(parents=True)
        for i in range(3):
            np.save(mels / spk / f"{spk}_{i:03d}_mel.npy",
                    rng.rand(80, 100 + 20 * i).astype(np.float32))
    return path, str(mels)


def test_parity_report_against_dvc_tpu(fixture_ckpt):
    path, mels = fixture_ckpt
    got = parity_report(path, mels, PC.Config(), device="cpu")
    want = jax_parity_report(path, mels, JC.Config())
    assert got["n_utterances"] == want["n_utterances"] == 6
    assert got["n_crops"] == want["n_crops"] and got["checkpoint"] == want["checkpoint"]
    for k in ("l1_per_frame", "l2_per_frame", "max_abs"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    model = load_reference_checkpoint(path, device="cpu")
    assert not model.training
    short = mel_reconstruction_error(model, [np.zeros((80, 10), np.float32)])
    assert short["n_crops"] == 1 and np.isfinite(short["l1_per_frame"])


# --- the presets, the auto backend, content_sensitivity ------------------------------

def test_presets_equal_dvc_tpus():
    assert dataclasses.asdict(PC.training_preset()) == dataclasses.asdict(JC.training_preset())
    for args in ((), ("a", "b")):
        (pc, ps), (jc, js) = PC.conversion_preset(*args), JC.conversion_preset(*args)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(ps) == dataclasses.asdict(js)
        assert [f.name for f in dataclasses.fields(PC.ConversionSpec)] == \
            [f.name for f in dataclasses.fields(JC.ConversionSpec)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        ps.src_spk = "x"


def test_mel_extractor_auto_backend(monkeypatch):
    """auto: the native engine below 64 wavs, the device from 64 on."""
    rng = np.random.RandomState(1)
    wavs = [(0.1 * rng.randn(n)).astype(np.float32) for n in rng.randint(2000, 6000, 64)]
    auto = BatchedMelExtractor(backend="auto", device="cpu")
    for n, backend in ((3, "native"), (64, "torch")):
        want = BatchedMelExtractor(backend=backend, device="cpu")(wavs[:n])
        got = auto(wavs[:n])
        assert len(got) == n and all(np.array_equal(g, w) for g, w in zip(got, want))
    calls = []
    from dvc_tpu_torch import native
    monkeypatch.setattr(native, "melspectrogram_batch",
                        lambda w, **kw: calls.append(len(w)) or [None] * len(w))
    auto(wavs[:63])
    auto(wavs)
    assert calls == [63]
    with pytest.raises(ValueError, match="unknown mel backend"):
        BatchedMelExtractor(backend="jax", device="cpu")


def test_content_sensitivity():
    rng = np.random.RandomState(2)
    srcs = (rng.rand(80, 70).astype(np.float32), rng.rand(80, 90).astype(np.float32))
    profile = (rng.rand(80), rng.rand(80) + 0.5)
    pt = tuple(profile_transfer_mel(s, *profile) for s in srcs)
    drone = (np.ones((80, 70)), np.ones((80, 60)))
    for outs in (pt, drone, srcs):
        assert content_sensitivity(outs, srcs) == jax_content_sensitivity(outs, srcs)
    assert content_sensitivity(srcs, srcs) == 1.0
    assert content_sensitivity(drone, srcs) == 0.0
