"""The WORLD route's analysis side of the port against dvc_tpu on the CPU: the
batched device analysis (world_decompose_batch), PairedMCCDataset,
preprocess-world, and the route's commands through main()
(tests/test_torch_port_world_serve.py holds the MCC-VAE, the conversion
and the service).

The signals are 0.5-0.9 s harmonic voices over a noise floor of 0.1, so
that CheapTrick resolves every band in dvc_tpu's float32 sum too
(tests/test_torch_port_mcd.py).  Limits (measured in brackets):
  * world_decompose_batch: voicing agreement >= 0.99 (1.0), median
    relative f0 error on frames voiced in both <= 1e-5 (2.9e-6), and the
    mc within 1e-3 of its range (4.0e-4: CheapTrick's window length moves
    with f0 by whole samples);
  * PairedMCCDataset: batches equal bit for bit under one seed;
  * preprocess-world --f0 native: the same files and keys, f0 equal, the
    statistics within 1e-5 absolute (1.4e-6), the MCCs within 1e-4 of
    their max (8.8e-5 on the wav resampled from 22.05 kHz, 9.5e-6 on the
    others) and normalized_mc, their quotient by a std near 0.05, within
    1e-3 of its max (6.2e-4).
"""

import dataclasses
import os

import numpy as np
import pytest

from dvc_tpu.data.dataset import PairedMCCDataset as JaxPairedMCCDataset
from dvc_tpu.data.world_preprocess import preprocess_world_dataset as jax_preprocess_world
from dvc_tpu.ops import world as jworld
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.data.dataset import PairedMCCDataset
from dvc_tpu_torch.data.world_preprocess import preprocess_world_dataset
from dvc_tpu_torch.ops import world as pworld
from dvc_tpu_torch.utils.wavio import read_wav, write_wav

SR = 16_000
MCC = dict(num_mels=36, frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
           dec_lstm2_hidden=32, postnet_channels=32)  # the narrow MCC-VAE of the CLI test
AGREE_MIN = 0.99
F0_MEDIAN_MAX = 1e-5
MC_RANGE_ATOL = 1e-3
STATS_ATOL = 1e-5
MCC_MAX_RTOL = 1e-4
NORM_MAX_RTOL = 1e-3


def voice(seed, seconds, f0c, sr=SR):
    """Harmonics of a moving f0 up to 7.9 kHz over a noise floor of 0.1."""
    r = np.random.RandomState(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0 = f0c * (1 + 0.04 * np.sin(2 * np.pi * 2.5 * t + seed))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    x = sum((0.3 / h) * np.sin(h * ph + r.rand() * 6.28) * (f0 * h < 7900) for h in range(1, 60))
    return (x + 0.1 * r.randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """2 speakers x 3 wavs of 0.55-0.9 s, one of them at 22.05 kHz."""
    root = tmp_path_factory.mktemp("wavs")
    for si, spk in enumerate(("p225", "p226")):
        (root / spk).mkdir()
        for u in range(3):
            sr = 22_050 if (si, u) == (1, 0) else SR
            write_wav(str(root / spk / f"{spk}_{u:03d}.wav"),
                      voice(10 * si + u, 0.55 + 0.15 * u, 120 + 70 * si + 8 * u, sr), sr)
    return root


@pytest.fixture(scope="module")
def world_dirs(wav_dir, tmp_path_factory):
    """preprocess-world --f0 native by both packages."""
    out = tmp_path_factory.mktemp("world")
    preprocess_world_dataset(str(wav_dir), str(out / "port"), device="cpu")
    jax_preprocess_world(str(wav_dir), str(out / "dvc"))
    return out / "port", out / "dvc"


def _rel_range(a, b):
    return float(np.abs(a - b).max() / np.ptp(b))


def test_world_decompose_batch_against_dvc_tpu(wav_dir):
    wavs = [read_wav(str(p))[0] for p in sorted((wav_dir / "p225").glob("*.wav"))]
    want = jworld.world_decompose_batch(wavs, SR, keep_sp_ap=False)
    got = pworld.world_decompose_batch(wavs, SR, keep_sp_ap=False, device="cpu")
    for w, (f0, ta, sp, ap, mc), (jf0, jta, _, _, jmc) in zip(wavs, got, want):
        n = len(w) // 80 + 1
        assert f0.shape == ta.shape == (n,) and mc.shape == jmc.shape == (n, 36)
        assert sp is None and ap is None and f0.dtype == np.float32
        np.testing.assert_array_equal(ta, jta)
        both = (f0 > 0) & (jf0 > 0)
        assert ((f0 > 0) == (jf0 > 0)).mean() >= AGREE_MIN and both.sum() >= 30
        assert np.median(np.abs(f0[both] - jf0[both]) / jf0[both]) <= F0_MEDIAN_MAX
        assert _rel_range(mc, jmc) <= MC_RANGE_ATOL
    with pytest.raises(NotImplementedError, match="device D4C.*not yet ported"):
        pworld.world_decompose_batch(wavs, SR, keep_sp_ap=True, device="cpu")
    with pytest.raises(ValueError, match=">= 64 samples"):
        pworld.world_decompose_batch([wavs[0][:10]], SR, keep_sp_ap=False, device="cpu")


def test_paired_mcc_dataset_batches(tmp_path):
    """One seed: the same pairs, crops or pads (at T <= 128 too) and batch
    order as dvc_tpu's over two epochs; normalized_mc read transposed."""
    rng = np.random.RandomState(0)
    for spk in ("p225", "p226"):
        (tmp_path / spk).mkdir()
        for u, t in enumerate((90, 128, 129, 200, 260)):
            np.savez(tmp_path / spk / f"{spk}_{u:03d}.npz",
                     normalized_mc=rng.randn(t, 36).astype(np.float32), f0=np.zeros(t))
    np.savez(tmp_path / "mcep_p225.npz", mean=np.zeros(36), std=np.ones(36))
    jds = JaxPairedMCCDataset(str(tmp_path), seed=5)
    pds = PairedMCCDataset(str(tmp_path), seed=5)
    assert pds.samples_length == 128 and pds.speaker_ids == ["p225", "p226"]
    for _ in range(2):
        np.testing.assert_array_equal(pds.utterance_fp, jds.utterance_fp)
        jb, pb = list(jds.batches(2)), list(pds.batches(2))
        assert len(pb) == len(jb) == 2
        for a, b in zip(jb, pb):
            assert b[0].shape == (2, 36, 128)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
        jds.shuffle_data()
        pds.shuffle_data()


def _npz(world, spk, i):
    fp = sorted((world / spk).glob("*.npz"))[i]
    with np.load(fp) as z:
        return dict(z)


def test_preprocess_world_native_against_dvc_tpu(world_dirs):
    port, dvc = world_dirs
    names = sorted(p.relative_to(dvc).as_posix() for p in dvc.rglob("*.npz"))
    assert names == sorted(p.relative_to(port).as_posix() for p in port.rglob("*.npz"))
    assert len(names) == 10
    for name in names:
        with np.load(dvc / name) as a, np.load(port / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                x, y = a[k], b[k]
                assert x.shape == y.shape and x.dtype == y.dtype, (name, k)
                err = float(np.abs(y - x).max())
                if k == "f0":
                    np.testing.assert_array_equal(y, x)
                elif k == "mcc":
                    assert err <= MCC_MAX_RTOL * np.abs(x).max(), (name, k)
                elif k == "normalized_mc":
                    assert err <= NORM_MAX_RTOL * np.abs(x).max(), (name, k)
                else:  # the statistics
                    assert err <= STATS_ATOL, (name, k)


def test_cli_world_route(wav_dir, world_dirs, tmp_path, monkeypatch, capsys):
    """preprocess-world --f0 device, train --features mcc (narrow widths),
    and convert-world with the native and the device synthesis and with
    --fs_mask, through main() on the CPU."""
    port, _ = world_dirs
    dev_dir = tmp_path / "world_dev"
    assert cli.main(["preprocess-world", str(wav_dir), "-o", str(dev_dir), "--f0", "device",
                     "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "p225: 3 files, logf0" in said and "p226: 3 files" in said
    for spk in ("p225", "p226"):
        for i in range(3):
            a, b = _npz(dev_dir, spk, i), _npz(port, spk, i)
            assert a.keys() == b.keys() and a["normalized_mc"].shape == b["normalized_mc"].shape
            assert ((a["f0"] > 0) == (b["f0"] > 0)).mean() >= 0.9

    real_config = cli._config_from_args

    def narrow(args):  # the flags set frames and num_mels; the widths are MCC's
        cfg = real_config(args)
        widths = {k: v for k, v in MCC.items() if k not in ("frames", "num_mels")}
        return cfg.replace(vae=dataclasses.replace(cfg.vae, **widths))

    monkeypatch.setattr(cli, "_config_from_args", narrow)
    run = tmp_path / "run"
    common = ["--dataset_fp", str(port), "--log_dir", str(run), "--samples_length", "16",
              "--device", "cpu"]
    assert cli.main(["train", *common, "--features", "mcc", "--epochs", "2",
                     "--report-interval", "2", "--batch-size", "1",
                     "--compute-dtype", "float32"]) == 0
    assert sorted(os.listdir(run / "checkpoints"))[-1] == "DisentangledVAE_VCTK_2.pth"
    cfg = (run / "config.json").read_text()
    assert '"num_mels": 36' in cfg and '"frames": 16' in cfg
    # train-fs reads mels whatever --features says, as dvc_tpu's does
    # (dvc_tpu/cli/run.py:504): a preprocess-world directory has none
    with pytest.raises(ValueError, match="need at least one array"):
        cli.main(["train-fs", *common, "--features", "mcc", "--fs_epochs", "1"])

    np.savez(tmp_path / "feature_mask.npz", mask=np.linspace(0, 1, 32).astype(np.float32),
             acc=0.5)
    out = run / "generation_world" / "p225_to_p226"
    wavs = {}
    for tag, flags in (("native", []), ("device", ["--synth", "device"]),
                       ("fs_mask", ["--fs_mask", str(tmp_path / "feature_mask.npz")])):
        assert cli.main(["convert-world", *common, "--src_spk", "p225", "--trg_spk", "p226",
                         *flags]) == 0
        files = sorted(out.glob("*.wav"))
        assert [f.name for f in files] == [f"convert_p225_to_p226_p225_00{i}.wav"
                                           for i in range(2)]
        wavs[tag] = [read_wav(str(f)) for f in files]
    for tag, got in wavs.items():
        for (w, sr), i in zip(got, range(2)):
            assert sr == SR and np.isfinite(w).all() and np.abs(w).max() > 0.5, tag
            assert len(w) == len(_npz(port, "p225", i)["f0"]) * 80
    assert not np.array_equal(wavs["native"][0][0], wavs["device"][0][0])
