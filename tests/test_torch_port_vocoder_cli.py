"""`train-vocoder` and `--vocoder istft` through the port's CLI on the CPU:
both archs train on a directory holding one 22.05 kHz wav (so the
resampler runs) and write checkpoints that dvc_tpu reads; `convert` and
`serve` take the iSTFT vocoder's; `--vocoder istft` without a checkpoint
exits with dvc_tpu's message; the command's flags and defaults are
dvc_tpu's, and it runs on cuda unless told otherwise."""

import numpy as np
import pytest

from dvc_tpu import config as JC
from dvc_tpu.cli import run as jcli
from dvc_tpu.convert import vocode as jvocode
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.convert.vocode import make_vocoder
from dvc_tpu_torch.utils.wavio import parse_wav, write_wav

SMALL = dict(layers=4, stacks=2, residual_channels=32, gate_channels=32,
             skip_out_channels=16)  # the CLI's --layers 4 --stacks 2 --residual_channels 32


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    sr = 22050
    t = np.arange(int(1.2 * sr)) / sr
    rng = np.random.RandomState(0)
    wav = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.1 * np.sin(2 * np.pi * 540 * t)
    write_wav(str(d / "spk_000.wav"), (wav + 0.01 * rng.randn(len(t))).astype(np.float32), sr)
    return d


@pytest.fixture(scope="module")
def mel_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mels")
    rng = np.random.RandomState(1)
    for spk, n in (("p1", 2), ("p2", 3)):
        (d / spk).mkdir()
        for i in range(n):
            np.save(d / spk / f"{spk}_{i:03d}_mel.npy",
                    (rng.rand(80, 20 + 9 * i) * 0.6).astype(np.float32))
    return d


def test_train_vocoder_wavenet(wav_dir, tmp_path, capsys):
    """The WaveNet at a small width: the EMA trail's msgpack, which dvc_tpu's
    make_vocoder and the port's vocoder read."""
    models = tmp_path / "models"
    assert cli.main(["train-vocoder", str(wav_dir), "-m", str(models), "--layers", "4",
                     "--stacks", "2", "--residual_channels", "32", "--n_steps", "3",
                     "--max_time_steps", "2048", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    path = models / "wavenet_step000000003.msgpack"
    assert "vocoder step 1: nll" in out and f"checkpoint -> {path}" in out
    jcfg = JC.VocoderConfig(**SMALL)
    params = jvocode.load_vocoder_params(str(path), jcfg)["params"]
    assert params["layer3"]["conv"]["kernel"].shape == (3, 32, 32)
    assert callable(jvocode.make_vocoder(str(path), jcfg))
    voc = make_vocoder(str(path), VocoderConfig(**SMALL), pad_frames_to=4, device="cpu")
    wav = voc(np.random.RandomState(2).rand(80, 3).astype(np.float32))
    assert wav.shape == (3 * 256,) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


def test_train_vocoder_istft_then_convert_and_serve(wav_dir, mel_dir, tmp_path, capsys,
                                                    monkeypatch):
    """The iSTFT vocoder at its default config (512 channels, 8 blocks) for
    two steps, then `convert --profile_transfer --vocoder istft` writes wavs
    of T * hop samples and `serve` builds with it."""
    models = tmp_path / "models"
    assert cli.main(["train-vocoder", str(wav_dir), "-m", str(models), "--arch", "istft",
                     "--n_steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    path = models / "istft_voc_step000000002.msgpack"
    assert "istft-voc step 1: loss" in out and f"checkpoint -> {path}" in out
    jvoc = jvocode.make_istft_vocoder(str(path))  # dvc_tpu reads it
    run = tmp_path / "run"
    common = ["--dataset_fp", str(mel_dir), "--log_dir", str(run), "--device", "cpu",
              "--profile_transfer", "--vocoder", "istft", "--vocoder_ckpt", str(path)]
    assert cli.main(["convert", *common, "--src_spk", "p1", "--trg_spk", "p2"]) == 0
    wavs = sorted((run / "generation" / "p1_to_p2").glob("*.wav"))
    assert len(wavs) == 2
    for w in wavs:
        wav, sr = parse_wav(w.read_bytes())
        assert sr == 16000 and np.isfinite(wav).all() and wav.std() > 0
        assert len(wav) % 256 == 0
    mel = np.load(mel_dir / "p1" / "p1_000_mel.npy")
    assert jvoc(mel).shape == (mel.shape[1] * 256,)
    served = {}

    def fake_serve(server, what):
        served["what"] = what
        server.server_close()

    monkeypatch.setattr(cli, "_serve_forever", fake_serve)
    assert cli.main(["serve", *common, "--port", "0"]) == 0
    assert "profile-transfer" in served["what"]


@pytest.mark.parametrize("cmd", ["convert", "serve"])
def test_vocoder_istft_needs_a_checkpoint(mel_dir, tmp_path, cmd):
    with pytest.raises(SystemExit, match="--vocoder istft needs --vocoder_ckpt"):
        cli.main([cmd, "--dataset_fp", str(mel_dir), "--log_dir", str(tmp_path),
                  "--device", "cpu", "--profile_transfer", "--vocoder", "istft"])


def test_train_vocoder_flags_are_dvc_tpus(monkeypatch):
    """The same flags and defaults as dvc_tpu's train-vocoder, plus --device."""
    seen = {}
    monkeypatch.setattr(jcli, "cmd_train_vocoder", lambda a: seen.setdefault("jax", a) and 0)
    monkeypatch.setattr(cli, "cmd_train_vocoder", lambda a: seen.setdefault("port", a) and 0)
    argv = ["train-vocoder", "wavs", "-m", "models"]
    jcli.main(argv)
    cli.main(argv)
    want = {k: v for k, v in vars(seen["jax"]).items() if k != "fn"}
    got = {k: v for k, v in vars(seen["port"]).items() if k != "fn"}
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("arch", ["wavenet", "istft"])
def test_train_vocoder_runs_on_cuda_by_default(wav_dir, tmp_path, arch):
    """No --device: cuda, which raises here (no card), before any step."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["train-vocoder", str(wav_dir), "-m", str(tmp_path), "--arch", arch])
    assert not list(tmp_path.iterdir())
