"""The verify recipe end to end through the port's CLI on the CPU
(.claude/skills/verify/SKILL.md steps 1-5): a synthetic VCTK-layout corpus
-> `preprocess --no_trim` -> `train` for 2 epochs -> `convert` (Griffin-Lim)
-> `eval-mcd`, each writing dvc_tpu's artifacts: `<utt>_mel.npy` and
`_sources.txt`, `DisentangledVAE_VCTK_<N>.msgpack` (beside the .pth pair),
converted wavs, per-utterance MCDs.  dvc_tpu's own `convert` then loads the
port's run directory.  The VAE's widths are cut to the tiny ones of
tests/test_train.py in both CLIs; frames are 16."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import dataclasses
import os

import numpy as np
import pytest

from dvc_tpu.cli import run as jcli
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.utils.wavio import write_wav

SMALL = dict(dim_neck=8, enc_channels=32, dim_pre=32, dec_lstm2_hidden=32,
             postnet_channels=32)
SR = 16_000


def utterance(seed: int, seconds: float) -> np.ndarray:
    r = np.random.RandomState(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0 = 110 + 12 * seed + 20 * np.sin(2 * np.pi * 0.8 * t)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    v = sum((0.3 / h) * np.sin(h * ph) * (f0 * h < 7900) for h in range(1, 70))
    return (v + 0.05 * r.randn(n)).astype(np.float32)


def _small(real):
    def config(args):
        cfg = real(args)
        return cfg.replace(vae=dataclasses.replace(cfg.vae, **SMALL))
    return config


@pytest.fixture
def small_widths(monkeypatch):
    monkeypatch.setattr(cli, "_config_from_args", _small(cli._config_from_args))
    monkeypatch.setattr(jcli, "_config_from_args", _small(jcli._config_from_args))


def test_verify_recipe_through_the_port_cli(tmp_path, small_widths, capsys):
    # 1. the corpus: 2 speakers x 4 utterances of 1.0-1.6 s
    wav_root = tmp_path / "vctk" / "VCTK-Corpus" / "wav16"
    for si, spk in enumerate(("p225", "p226")):
        (wav_root / spk).mkdir(parents=True)
        for u in range(4):
            write_wav(str(wav_root / spk / f"{spk}_{u:03d}.wav"),
                      utterance(10 * si + u, 1.0 + 0.2 * u))
    mels, run = tmp_path / "mels", tmp_path / "run"

    # 2. preprocess
    assert cli.main(["preprocess", str(tmp_path / "vctk"), "-o", str(mels), "-d", "VCTK",
                     "--no_trim", "--device", "cpu"]) == 0
    assert "preprocessed 8 files" in capsys.readouterr().out
    for spk in ("p225", "p226"):
        names = sorted(os.listdir(mels / spk))
        assert names == ["_sources.txt"] + [f"{spk}_{u:03d}_mel.npy" for u in range(4)]
        lines = (mels / spk / "_sources.txt").read_text().splitlines()
        assert [ln.split(",")[0] for ln in lines] == names[1:]
        for n in names[1:]:
            m = np.load(mels / spk / n)
            assert m.shape[0] == 80 and m.shape[1] > 16 and 0 <= m.min() and m.max() <= 1

    # 3. train 2 epochs
    common = ["--dataset_fp", str(mels), "--log_dir", str(run), "--samples_length", "16",
              "--device", "cpu"]
    assert cli.main(["train", *common, "--epochs", "2", "--report-interval", "1",
                     "--batch-size", "2", "--compute-dtype", "float32"]) == 0
    out = capsys.readouterr().out
    assert out.count("====> Epoch") == 2
    assert sorted(os.listdir(run / "checkpoints")) == [
        f"DisentangledVAE_VCTK_{e}{s}" for e in (1, 2) for s in (".msgpack", ".opt.pth", ".pth")]

    # 4. convert with the Griffin-Lim default
    assert cli.main(["convert", *common, "--src_spk", "p225", "--trg_spk", "p226",
                     "--num_utterances", "2", "--gl_iters", "4"]) == 0
    gen = run / "generation" / "p225_to_p226"
    # the wavs, and dvc_tpu's four mel PNGs an utterance
    assert sorted(os.listdir(gen)) == sorted(
        [f"convert_p225_to_p226_{u:03d}.wav" for u in range(2)]
        + [f"{kind}_{u:03d}.png" for u in range(2) for kind in (
            "original_p225", "convert_p225_p226", "recons_p225", "spectral_detail_p225_p226")])
    capsys.readouterr()

    # 5. eval-mcd: the converted wavs against their sources, and the sources
    # against themselves
    assert cli.main(["eval-mcd", "--src_dir", str(wav_root / "p225"), "--cvt_dir",
                     str(run / "generation"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    mcds = [float(ln.split("mcd: ")[1]) for ln in out if "mcd:" in ln]
    assert len(mcds) == 2 and all(np.isfinite(m) and m > 0 for m in mcds)
    assert cli.main(["eval-mcd", "--src_dir", str(wav_root), "--cvt_dir", str(wav_root),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [float(ln.split("mcd: ")[1]) for ln in out if "mcd:" in ln] == [0.0] * 8

    # dvc_tpu's own convert resumes the port's run directory
    assert jcli.main(["convert", "--dataset_fp", str(mels), "--log_dir", str(run),
                      "--samples_length", "16", "--src_spk", "p225", "--trg_spk", "p226",
                      "--num_utterances", "1", "--vocoder", "none"]) == 0
    assert "loaded checkpoint at epoch 2" in capsys.readouterr().out
