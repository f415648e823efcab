"""FeatureSelection and `train-fs` of the port against dvc_tpu on the CPU:
the mask, the classifier and the reference's loss with the weights carried
across, one Adam step against dvc_tpu's make_fs_step, two epochs of
FeatureSelectionTrainer.train (per-epoch loss and accuracy, the mask), and
`train` -> `train-fs` -> `convert --fs_mask --analyze` through the CLI at
tiny widths, with dvc_tpu reading the port's feature_mask.npz and writing
its own latent analysis from the same checkpoint."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import argparse
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.cli import run as jcli
from dvc_tpu.config import Config as JaxConfig
from dvc_tpu.models.feature_selection import feature_selection_loss as jax_fs_loss
from dvc_tpu.train.feature_selection_trainer import FeatureSelectionTrainer as JaxFSTrainer
from dvc_tpu.train.feature_selection_trainer import create_fs_state, make_fs_step as jax_fs_step
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import Config
from dvc_tpu_torch.models.feature_selection import FeatureSelection, feature_selection_loss
from dvc_tpu_torch.train.feature_selection_trainer import FeatureSelectionTrainer, make_fs_step
from dvc_tpu_torch.utils.convert import feature_selection_state_dict_from_jax
from test_torch_port_train import SMALL, _mel_tree, _np_tree

D, N_SPK = 32, 3
TOL = 1e-5        # one MLP pass and one step, float32 sums in another order
LR = 1e-3
GRAD_RTOL = 1e-3  # gradients, of their max (test_torch_port_train.py's limit)
RESOLVED = 1e-6   # 100 x Adam's eps: above it a step is within 1% of +-lr
EPOCH_TOL = 1e-4  # per-epoch means after two epochs of steps
# the analysis' latent means and stds: the tiny VAE's encode in each package
ANALYSIS_RTOL, ANALYSIS_ATOL = 1e-4, 1e-4


def _data(seed, n=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, D).astype(np.float32),
            rng.randint(0, N_SPK, n).astype(np.int32))


def _port_fs(params):
    fs = FeatureSelection(D, N_SPK)
    fs.load_state_dict(feature_selection_state_dict_from_jax(_np_tree(params)))
    return fs


def test_forward_classify_loss():
    """The sigmoid mask, the softmaxed classifier on masked latents and the
    reference's log_softmax-of-softmax loss, against flax's."""
    model, state, _ = create_fs_state(jax.random.PRNGKey(0), D, N_SPK)
    fs = _port_fs(state.params)
    x, y = _data(1)
    v = {"params": state.params}
    mask = model.apply(v, jnp.asarray(x))
    pred = model.apply(v, jnp.asarray(x) * mask, method="classify")
    loss = jax_fs_loss(pred, jnp.asarray(y))
    with torch.no_grad():
        m = fs(torch.from_numpy(x))
        p = fs.classify(torch.from_numpy(x) * m)
        l_ = feature_selection_loss(p, torch.from_numpy(y))
    np.testing.assert_allclose(m.numpy(), np.asarray(mask), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(pred), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l_.item(), float(loss), rtol=TOL)
    # not plain cross-entropy of the logits: the reference's composition
    plain = torch.nn.functional.cross_entropy(torch.log(p), torch.from_numpy(y).long())
    assert abs(plain.item() - l_.item()) > 1e-3


def test_fs_step():
    """One Adam step against dvc_tpu's make_fs_step: loss, accuracy, every
    gradient (Adam's first moment after one step is 0.1 g) and every
    updated parameter.  Adam's first step is lr * g / (|g| + 1e-8): where
    |g| is near that eps (the squashed loss makes some gradients that
    small) the step turns the gradient's rounding into parameter error, so
    the parameters are held where |g| > RESOLVED, and every step to lr."""
    model, state, opt = create_fs_state(jax.random.PRNGKey(0), D, N_SPK)
    fs = _port_fs(state.params)
    x, y = _data(2, n=8)
    new, loss, acc = jax_fs_step(model, opt)(state, jnp.asarray(x), jnp.asarray(y))
    got_loss, got_acc = make_fs_step(fs, torch.optim.Adam(fs.parameters(), lr=LR))(
        torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=TOL)
    assert got_acc.item() == float(acc)
    ref = feature_selection_state_dict_from_jax(_np_tree(new.params))
    ref_g = feature_selection_state_dict_from_jax(
        _np_tree(jax.tree_util.tree_map(lambda m: m / 0.1, new.opt_state[0].mu)))
    for name, p in fs.named_parameters():
        g, w = p.grad.numpy(), ref_g[name].numpy()
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max(), name
        sure = np.abs(w) > RESOLVED
        np.testing.assert_allclose(p.detach().numpy()[sure], ref[name].numpy()[sure],
                                   atol=TOL, err_msg=name)
        assert np.abs(p.detach().numpy() - ref[name].numpy()).max() <= 2 * LR, name


def _recorded(step_fn, losses):
    """step_fn, recording each step's loss and accuracy."""
    def step(*args):
        out = step_fn(*args)
        losses.append((float(out[-2]), float(out[-1])))
        return out
    return step


def test_trainer_two_epochs():
    """FeatureSelectionTrainer.train for 2 epochs from the same init on the
    same latents: the same batches (RandomState(0) permutations, the
    partial batch dropped), per-epoch loss and accuracy, log lines' shape
    and mask."""
    latents, labels = _data(3, n=22)
    jtr = JaxFSTrainer(D, N_SPK)
    ptr = FeatureSelectionTrainer(D, N_SPK, device="cpu")
    ptr.model.load_state_dict(feature_selection_state_dict_from_jax(_np_tree(jtr.state.params)))
    jsteps, psteps = [], []
    jtr.step_fn = _recorded(jtr.step_fn, jsteps)
    ptr.step_fn = _recorded(ptr.step_fn, psteps)
    jsaid, psaid = [], []
    want = jtr.train(latents, labels, epochs=2, batch_size=8, logging_func=jsaid.append)
    got = ptr.train(latents, labels, epochs=2, batch_size=8, logging_func=psaid.append)
    assert len(psteps) == len(jsteps) == 2 * 2  # 22 // 8 batches an epoch
    for e in range(2):
        for k in (0, 1):
            np.testing.assert_allclose(np.mean([s[k] for s in psteps[2 * e:2 * e + 2]]),
                                       np.mean([s[k] for s in jsteps[2 * e:2 * e + 2]]),
                                       atol=EPOCH_TOL)
    assert got["epoch"] == want["epoch"] == 1
    np.testing.assert_allclose([got["loss"], got["acc"]], [want["loss"], want["acc"]],
                               atol=EPOCH_TOL)
    assert [s.split(":")[0] for s in psaid] == [s.split(":")[0] for s in jsaid] == [
        "fs epoch 0", "fs epoch 1"]
    np.testing.assert_allclose(ptr.feature_mask(latents), jtr.feature_mask(latents),
                               atol=EPOCH_TOL)
    with pytest.raises(ValueError, match="no latents"):
        ptr.train(latents[:0], labels[:0])


def test_cli_train_fs_then_analyze(tmp_path, monkeypatch, capsys):
    """`train` 1 epoch, `train-fs --fs_epochs 2` (feature_mask.npz with
    mask and acc, read by dvc_tpu's --fs_mask loader to the same binary
    mask), then `convert --fs_mask ... --analyze`: the latent analysis and
    the FS mask's npz and PNGs, the analysis equal to dvc_tpu's `convert
    --analyze` on the same checkpoint."""
    _mel_tree(str(tmp_path / "mels"), speakers=("p225", "p226", "p227"), utts=4,
              t_range=(20, 40))

    def small(real):
        def config(args):
            cfg = real(args)
            widths = {k: v for k, v in SMALL.items() if k != "frames"}
            return cfg.replace(vae=dataclasses.replace(cfg.vae, **widths))
        return config

    monkeypatch.setattr(cli, "_config_from_args", small(cli._config_from_args))
    monkeypatch.setattr(jcli, "_config_from_args", small(jcli._config_from_args))
    run = tmp_path / "run"
    common = ["--dataset_fp", str(tmp_path / "mels"), "--log_dir", str(run),
              "--samples_length", "16", "--batch-size", "4"]
    assert cli.main(["train", *common, "--epochs", "1", "--report-interval", "1",
                     "--compute-dtype", "float32", "--device", "cpu"]) == 0
    assert cli.main(["train-fs", *common, "--fs_epochs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "loaded VAE checkpoint at epoch 1" in out and "fs epoch 1:" in out
    fm = np.load(run / "feature_mask.npz")
    assert sorted(fm.files) == ["acc", "mask"] and fm["mask"].shape == (32,)
    assert np.all((fm["mask"] > 0) & (fm["mask"] < 1)) and 0 <= float(fm["acc"]) <= 1

    flags = ["--fs_mask", str(run / "feature_mask.npz"), "--fs_threshold", "0.5"]
    args = argparse.Namespace(fs_mask=str(run / "feature_mask.npz"), fs_threshold=0.5,
                              fs_top_k=None)
    raw, mask = cli._load_fs_mask(args, Config())
    jraw, jmask = jcli._load_fs_mask(args, JaxConfig())
    np.testing.assert_array_equal(raw, jraw)
    np.testing.assert_array_equal(mask, jmask)

    jrun = tmp_path / "jrun"
    shutil.copytree(run / "checkpoints", jrun / "checkpoints")
    conv = ["--src_spk", "p225", "--trg_spk", "p226", "--num_utterances", "1", "--vocoder",
            "none", *flags, "--analyze"]
    assert cli.main(["convert", *common, *conv, "--device", "cpu"]) == 0
    jcommon = [a if a != str(run) else str(jrun) for a in common]
    assert jcli.main(["convert", *jcommon, *conv]) == 0
    gen, jgen = run / "generation", jrun / "generation"
    names = {"latent_analysis.png", "latent_analysis.npz", "fs_mask.png", "fs_mask.npz",
             "p225_to_p226"}
    assert set(os.listdir(gen)) == set(os.listdir(jgen)) == names
    got, want = np.load(gen / "latent_analysis.npz"), np.load(jgen / "latent_analysis.npz")
    assert list(got["speakers"]) == list(want["speakers"]) == ["p225", "p226", "p227"]
    for k in ("mus", "stds"):
        assert got[k].shape == (3, 32)
        np.testing.assert_allclose(got[k], want[k], rtol=ANALYSIS_RTOL, atol=ANALYSIS_ATOL)
    got, want = np.load(gen / "fs_mask.npz"), np.load(jgen / "fs_mask.npz")
    for k in ("sigmoid_mask", "binary_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert sorted(os.listdir(gen / "p225_to_p226")) == sorted(os.listdir(jgen / "p225_to_p226"))
