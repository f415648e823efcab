"""The port's mel and latent PNGs against dvc_tpu's on the CPU: the
plotting functions (each writes what dvc_tpu's writes, and without
matplotlib nothing but plot_latent_analysis' npz), VoiceConverter's four
PNGs an utterance under dvc_tpu's names, and the Trainer's estimation PNGs
at each report interval, whose failures are counted and logged."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import os

import numpy as np

from dvc_tpu.config import Config as JaxConfig
from dvc_tpu.config import VAEConfig as JaxVAEConfig
from dvc_tpu.convert import conversion as jconv
from dvc_tpu.utils import plotting as jplot
from dvc_tpu_torch.config import Config, VAEConfig
from dvc_tpu_torch.convert import conversion
from dvc_tpu_torch.data.dataset import PairedMelDataset
from dvc_tpu_torch.train.trainer import Trainer
from dvc_tpu_torch.utils import plotting
from test_torch_port_train import _mel_tree, tiny_config
from test_torch_port_vae import SMALL, pair  # noqa: F401


def _calls(mod, root):
    """Every plotting function of ``mod`` once, into ``root``; returns the
    functions' results."""
    rng = np.random.RandomState(0)
    mus, stds = rng.randn(3, 8), rng.rand(3, 8)
    return [
        mod.save_mel_png(rng.rand(80, 30), str(root / "mel.png"), "t"),
        mod.encoding_visualization(rng.randn(8), str(root / "code.png"), "a"),
        mod.projection_plot(rng.randn(12, 4), np.repeat([0, 1, 2], 4), str(root / "proj.png")),
        mod.plot_fs_mask(rng.rand(8), str(root / "fs_mask.png"), 0.5, 2),
        mod.plot_latent_analysis(mus, stds, ["a", "b", "c"], str(root / "latent.png"),
                                 str(root / "latent.npz")),
    ]


def test_plotting_functions(tmp_path):
    """Each function writes the file dvc_tpu's writes; without matplotlib
    each returns False, and only plot_latent_analysis' npz is written."""
    for name, mod in (("port", plotting), ("jax", jplot)):
        (tmp_path / name).mkdir()
        assert _calls(mod, tmp_path / name) == [True] * 5
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "code.png", "fs_mask.png", "latent.npz", "latent.png", "mel.png", "proj.png"]
    a, b = np.load(tmp_path / "port" / "latent.npz"), np.load(tmp_path / "jax" / "latent.npz")
    for k in ("mus", "stds", "speakers"):
        np.testing.assert_array_equal(a[k], b[k])

    (tmp_path / "none").mkdir()
    old = plotting._plt
    plotting._plt = lambda: None
    try:
        assert _calls(plotting, tmp_path / "none") == [False] * 5
    finally:
        plotting._plt = old
    assert os.listdir(tmp_path / "none") == ["latent.npz"]


def _mel_dirs(root):
    rng = np.random.RandomState(5)
    for spk, n in (("p1", 2), ("p2", 1)):
        (root / spk).mkdir()
        for i in range(n):
            np.save(root / spk / f"{spk}_{i:03d}_mel.npy",
                    rng.rand(80, 20 + 7 * i).astype(np.float32))


def test_converter_pngs(pair, tmp_path, monkeypatch):
    """VoiceConverter writes dvc_tpu's four PNGs an utterance (original,
    convert, recons, spectral_detail) under the same names; save_png=False
    and a missing matplotlib write none."""
    jm, variables, pm = pair
    _mel_dirs(tmp_path)
    jconv.VoiceConverter(JaxConfig(vae=JaxVAEConfig(**SMALL)), jm, variables, seed=3
                         ).convert_speaker_pair(str(tmp_path), "p1", "p2",
                                                str(tmp_path / "gen_jax"), 2)
    conv = conversion.VoiceConverter(Config(vae=VAEConfig(**SMALL)), pm, seed=3)
    conv.convert_speaker_pair(str(tmp_path), "p1", "p2", str(tmp_path / "gen_port"), 2)
    names = sorted(os.listdir(tmp_path / "gen_port" / "p1_to_p2"))
    assert names == sorted(os.listdir(tmp_path / "gen_jax" / "p1_to_p2"))
    assert names == sorted(f"{kind}_{u:03d}.png" for u in range(2) for kind in (
        "original_p1", "convert_p1_p2", "recons_p1", "spectral_detail_p1_p2"))
    conv.convert_speaker_pair(str(tmp_path), "p1", "p2", str(tmp_path / "gen_off"), 2,
                              save_png=False)
    monkeypatch.setattr(plotting, "_plt", lambda: None)
    conv.convert_speaker_pair(str(tmp_path), "p1", "p2", str(tmp_path / "gen_none"), 2)
    for d in ("gen_off", "gen_none"):
        assert os.listdir(tmp_path / d / "p1_to_p2") == []


def test_estimation_pngs(tmp_path, monkeypatch):
    """run_training with an estimation_dir reloads each saved checkpoint and
    writes min(5, batch) pairs {epoch}_recons_mel_{i}.png and
    {epoch}_original_mel_{i}.png; a failing PNG is logged once and counted,
    and training goes on."""
    _mel_tree(str(tmp_path / "mels"))
    ds = PairedMelDataset(str(tmp_path / "mels"), samples_length=16, seed=0)
    est = tmp_path / "images" / "estimation"
    tr = Trainer(tiny_config(), checkpoints_path=str(tmp_path / "ck"),
                 estimation_dir=str(est), device="cpu")
    tr.run_training(ds, 2, report_interval=2, logging_func=lambda *a: None)
    assert sorted(os.listdir(est)) == sorted(f"2_{k}_mel_{i}.png"
                                             for k in ("original", "recons") for i in range(2))
    assert tr.model.training

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(plotting, "save_mel_png", broken)
    said = []
    tr.run_training(ds, 1, report_interval=1, logging_func=said.append)
    assert said[1:] == ["estimation png dump failed: OSError: disk full",
                        "estimation png dump: 2 images failed"]
    assert sorted(os.listdir(tmp_path / "ck"))[-1] == "DisentangledVAE_VCTK_3.pth"


def test_estimation_failure_does_not_stop_training(tmp_path, monkeypatch):
    """An exception outside the PNG loop (here the reload) is reported as
    "estimation dump failed" and the epoch loop goes on, as in dvc_tpu."""
    _mel_tree(str(tmp_path / "mels"))
    ds = PairedMelDataset(str(tmp_path / "mels"), samples_length=16, seed=0)
    tr = Trainer(tiny_config(), checkpoints_path=str(tmp_path / "ck"),
                 estimation_dir=str(tmp_path / "est"), device="cpu")

    def broken(*a, **k):
        raise RuntimeError("no backend")

    monkeypatch.setattr(tr, "estimate_trained_model", broken)
    said = []
    hist = tr.run_training(ds, 2, report_interval=1, logging_func=said.append)
    assert len(hist) == 2
    assert [s for s in said if "estimation" in s] == [
        "estimation dump failed: RuntimeError: no backend"] * 2
