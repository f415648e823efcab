"""`train-speaker`, `embed`, `eval-eer` and `train-autovc` through the port's
CLI on the CPU, at the full SpeakerEncoderConfig and AutoVCConfig: each
file the port writes loads in dvc_tpu (its GE2E trainer's resume, `embed`
and `eval-eer` on the port's run, AutoVCState from_bytes), and each file
dvc_tpu writes loads in the port.  The commands' flags and defaults are
dvc_tpu's, and they run on cuda unless told otherwise."""

import re

import jax
import numpy as np
import pytest
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.cli import run as jcli
from dvc_tpu.train import autovc_trainer as jat
from dvc_tpu.train.speaker_trainer import SpeakerEncoderTrainer as JaxTrainer
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import AutoVCConfig, SpeakerEncoderConfig
from dvc_tpu_torch.models.autovc import AutoVC
from dvc_tpu_torch.train.autovc_trainer import load_autovc_state
from dvc_tpu_torch.train.speaker_trainer import SpeakerEncoderTrainer
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import speaker_encoder_tree_from_state_dict
from dvc_tpu_torch.utils.wavio import write_wav

SPEAKERS = ("p1", "p2", "p3", "p4")
# embeddings of the same run by the two packages: the encoder's forward
# gate (2e-4 / 2e-5) through the mel front end's float32 differences
EMBED_ATOL = 1e-4


@pytest.fixture(scope="module")
def mel_root(tmp_path_factory):
    """4 speakers x 5 mels (80, 40-90), each speaker a smooth spectral
    profile under random content."""
    root = tmp_path_factory.mktemp("mels")
    rng = np.random.RandomState(0)
    bins = np.arange(80)[:, None]
    for si, spk in enumerate(SPEAKERS):
        (root / spk).mkdir()
        prof = np.exp(-0.5 * ((bins - 10 - 18 * si) / 6.0) ** 2)
        for u in range(5):
            t = 40 + 12 * u
            mel = prof * rng.uniform(0.4, 0.9, (1, t)) + 0.1 * rng.rand(80, t)
            np.save(root / spk / f"{spk}_{u:03d}.npy", np.clip(mel, 0, 1).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.RandomState(1)
    t = np.arange(16_000) / 16_000
    for i, f0 in enumerate((140.0, 220.0)):
        (d / f"s{i}").mkdir()
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.randn(len(t))
        write_wav(str(d / f"s{i}" / "u0.wav"), wav.astype(np.float32), 16_000)
    return d


@pytest.fixture(scope="module")
def port_run(mel_root, tmp_path_factory):
    """The port's train-speaker: 4 steps of 4 speakers x 2 utterances on the
    resident pool, a save every 2 steps, a backup and a projection."""
    models = tmp_path_factory.mktemp("ge2e_port")
    assert cli.main(["train-speaker", "ge2e", str(mel_root), "-m", str(models),
                     "--n_steps", "4", "--speakers_per_batch", "4",
                     "--utterances_per_speaker", "2", "--save_every", "2",
                     "--backup_every", "4", "--umap_every", "2", "--device", "cpu"]) == 0
    return models


def _eer_of(out: str) -> float:
    return float(re.search(r"verification EER over 20 utterances, 4 speakers: ([0-9.]+)",
                           out).group(1))


def test_port_run_in_both_packages(port_run, mel_root, wav_dir, tmp_path, capsys):
    """The port's GE2E run: its files, dvc_tpu's resume of them, `embed` of
    both packages on it (the same embeddings), `eval-eer` of both."""
    names = sorted(p.name for p in port_run.iterdir())
    assert names == ["ge2e.msgpack", "ge2e_bak_000004.msgpack", "viz"]
    viz = sorted(p.name for p in (port_run / "viz").iterdir())
    assert {"ge2e_params.json", "ge2e_dataset.json", "ge2e_curves.png",
            "ge2e_umap_000002.png", "ge2e_umap_000004.png"} <= set(viz)
    jt = JaxTrainer(JC.SpeakerEncoderConfig(speakers_per_batch=4, utterances_per_speaker=2),
                    models_dir=str(port_run), use_mesh=False)
    assert jt.resume() and int(jt.state.step) == 4
    pt = SpeakerEncoderTrainer(SpeakerEncoderConfig(), models_dir=str(port_run), device="cpu")
    assert pt.resume() and pt.step == 4
    want = speaker_encoder_tree_from_state_dict(pt.model.state_dict())
    np.testing.assert_array_equal(np.asarray(jt.state.params["linear"]["kernel"]),
                                  want["linear"]["kernel"])

    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = tmp_path / name
        assert main(["embed", "ge2e", str(wav_dir), "-m", str(port_run), "-o", str(out),
                     *extra]) == 0
        assert f"embedded 2 utterances -> {out}" in capsys.readouterr().out
        outs[name] = {p.name: np.load(p) for p in out.iterdir()}
        assert main(["eval-eer", "ge2e", str(mel_root), "-m", str(port_run), *extra]) == 0
        outs[name + "_eer"] = _eer_of(capsys.readouterr().out)
    assert sorted(outs["port"]) == sorted(outs["jax"]) == ["s0_u0_embed.npy", "s1_u0_embed.npy"]
    for k, e in outs["port"].items():
        assert e.shape == (256,) and abs(np.linalg.norm(e) - 1.0) < 1e-5
        np.testing.assert_allclose(e, outs["jax"][k], atol=EMBED_ATOL)
    assert 0.0 <= outs["port_eer"] <= 1.0
    assert abs(outs["port_eer"] - outs["jax_eer"]) <= 0.02


def test_dvc_tpu_run_in_the_port(mel_root, wav_dir, tmp_path, capsys):
    """dvc_tpu's train-speaker run (host sampler) resumes in the port, whose
    `embed` and `eval-eer` read it; resuming it in the port's train-speaker
    continues the step count and writes a file dvc_tpu resumes again."""
    models = tmp_path / "ge2e_jax"
    assert jcli.main(["train-speaker", "ge2e", str(mel_root), "-m", str(models),
                      "--n_steps", "2", "--speakers_per_batch", "4",
                      "--utterances_per_speaker", "2", "--save_every", "2",
                      "--umap_every", "0", "--no_resident_pool"]) == 0
    assert cli.main(["embed", "ge2e", str(wav_dir), "-m", str(models), "-o",
                     str(tmp_path / "emb"), "--device", "cpu"]) == 0
    assert len(list((tmp_path / "emb").glob("*_embed.npy"))) == 2
    assert cli.main(["eval-eer", "ge2e", str(mel_root), "-m", str(models), "--device",
                     "cpu"]) == 0
    assert 0.0 <= _eer_of(capsys.readouterr().out) <= 1.0
    assert cli.main(["train-speaker", "ge2e", str(mel_root), "-m", str(models),
                     "--n_steps", "2", "--speakers_per_batch", "4",
                     "--utterances_per_speaker", "2", "--save_every", "2",
                     "--umap_every", "0", "--no_resident_pool", "--device", "cpu"]) == 0
    assert "resumed ge2e at step 2" in capsys.readouterr().out
    jt = JaxTrainer(JC.SpeakerEncoderConfig(speakers_per_batch=4, utterances_per_speaker=2),
                    models_dir=str(models), use_mesh=False)
    assert jt.resume() and int(jt.state.step) == 4


def _autovc_template():
    return jat.create_autovc_state(jax.random.PRNGKey(0), JC.AutoVCConfig(), frames=64)[1]


@pytest.mark.parametrize("encoder", [True, False])
def test_train_autovc(encoder, port_run, mel_root, tmp_path, capsys):
    """2 epochs at batch 8 (the 8 pairs of the corpus), conditioned on the
    port's GE2E run or on one-hot codes: finite epoch losses, a checkpoint
    each epoch, each read by dvc_tpu's from_bytes and by the port."""
    run = tmp_path / "autovc"
    extra = ["--encoder_run_id", "ge2e", "-m", str(port_run)] if encoder else []
    assert cli.main(["train-autovc", "--dataset_fp", str(mel_root), "--log_dir", str(run),
                     "--epochs", "2", "--report-interval", "1", "--device", "cpu",
                     *extra]) == 0
    losses = [float(x) for x in re.findall(r"====> AutoVC epoch \d: loss ([0-9.]+)",
                                           capsys.readouterr().out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(p.name for p in run.iterdir()) == ["autovc_1.msgpack", "autovc_2.msgpack"]
    blob = (run / "autovc_2.msgpack").read_bytes()
    restored = serialization.from_bytes(_autovc_template(), blob)
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    assert load_autovc_state(msgpack.unpackb(blob), AutoVC(AutoVCConfig())) == 2


def test_dvc_tpu_autovc_file_in_the_port(mel_root, tmp_path):
    """dvc_tpu's train-autovc checkpoint loads into the port's AutoVC (and
    its Adam), weights equal."""
    import torch
    run = tmp_path / "autovc_jax"
    assert jcli.main(["train-autovc", "--dataset_fp", str(mel_root), "--log_dir", str(run),
                      "--epochs", "1"]) == 0
    blob = (run / "autovc_1.msgpack").read_bytes()
    restored = serialization.from_bytes(_autovc_template(), blob)
    model = AutoVC(AutoVCConfig())
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    assert load_autovc_state(msgpack.unpackb(blob), model, opt) == int(restored.step) == 1
    np.testing.assert_array_equal(
        model.decoder.linear_projection.linear_layer.weight.detach().numpy().T,
        np.asarray(restored.params["decoder"]["linear_projection"]["dense"]["kernel"]))


@pytest.mark.parametrize("argv", [
    ["train-speaker", "run", "mels", "-m", "models"],
    ["embed", "run", "wavs", "-m", "models", "-o", "out"],
    ["eval-eer", "run", "mels", "-m", "models"],
    ["train-autovc", "--dataset_fp", "mels"],
])
def test_flags_are_dvc_tpus(argv, monkeypatch):
    """The same flags and defaults as dvc_tpu's command, plus --device cuda."""
    name = "cmd_" + argv[0].replace("-", "_")
    seen = {}
    monkeypatch.setattr(jcli, name, lambda a: seen.setdefault("jax", a) and 0)
    monkeypatch.setattr(cli, name, lambda a: seen.setdefault("port", a) and 0)
    jcli.main(argv)
    cli.main(argv)
    want = {k: v for k, v in vars(seen["jax"]).items() if k != "fn"}
    got = {k: v for k, v in vars(seen["port"]).items() if k != "fn"}
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("cmd", ["train-speaker", "embed", "eval-eer", "train-autovc"])
def test_commands_run_on_cuda_by_default(cmd, port_run, mel_root, wav_dir, tmp_path):
    """No --device: cuda, which raises here (no card), before any output."""
    argv = {"train-speaker": ["train-speaker", "x", str(mel_root), "-m", str(tmp_path / "m"),
                              "--no_resident_pool"],
            "embed": ["embed", "ge2e", str(wav_dir), "-m", str(port_run), "-o",
                      str(tmp_path / "e")],
            "eval-eer": ["eval-eer", "ge2e", str(mel_root), "-m", str(port_run)],
            "train-autovc": ["train-autovc", "--dataset_fp", str(mel_root), "--log_dir",
                             str(tmp_path / "a")]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)
    assert not list(tmp_path.iterdir())
