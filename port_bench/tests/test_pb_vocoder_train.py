"""The vocoder training cell (``train-vocoder-b2``) on the CPU: a tiny-width
rehearsal of drivers/train_steps.py against the port's CPU path, sound and
with each fault planted; the corpus checks alone; and the cell's three new
readers on synthetic records.  The control (the reference in TF32 in the
program's place) exists only on the card (marked ``card``)."""

import copy
import importlib.util
import time

import numpy as np
import pytest
import torch

from port_bench import common
from port_bench.costs import vocoder
from port_bench.drivers import Context, train_steps
from port_bench.tests import tiny
from port_bench.trace import DeviceTrace

CELL = "train-vocoder-b2"


def vocoder_ctx(variant=None, seed: int = 2 ** 31 + 5, device: str = "cpu") -> Context:
    """The cell at a tiny width: 4 layers of 16 channels, crops of 1,024
    samples (4 frames), 3 speakers x 2 wavs of 0.3-0.5 s, calls of 4 steps."""
    c = common.load_cell(CELL)
    cfg = copy.deepcopy(c.config)
    cfg["vocoder"].update(tiny.TINY_VOC)
    cfg["train"]["max_time_steps"] = 1024
    tr = dict(c.traffic, speakers=3, files_per_speaker=2, steps_per_call=4,
              lengths=dict(median_s=0.4, sigma=0.35, min_s=0.3, max_s=0.5))
    return Context(config=cfg, traffic=tr, settings=c.settings, seed=seed, seconds=0.5,
                   trace=False, device=device, t_start=time.perf_counter(), variant=variant)


def checks(out):
    return {c.name: c.value for c in out.checks}


def test_sound_rehearsal_passes_every_check():
    out = train_steps.run(vocoder_ctx())
    c = checks(out)
    assert set(c) == {"loss_gap", "grad_gap", "change_gap", "grad_err", "ema_gap",
                      "crop_rows_off", "cond_err"}
    assert all(x.ok for x in out.checks), c
    assert c["loss_gap"] < 1e-5 and c["grad_gap"] < 1e-4 and c["grad_err"] < 1e-5
    assert c["ema_gap"] < 1e-3
    assert c["crop_rows_off"] == 0 and c["cond_err"] < 1e-5
    assert out.attempted >= 4 and out.attempted % 4 == 0
    assert out.end_to_end["train_frames_per_s"] > 0 and out.end_to_end["setup_s"] > 0
    rec = out.records
    assert rec["steps"] == out.attempted and rec["calls"] == out.attempted // 4
    names = {s["name"] for s in rec["spans"]}
    assert {"train.step", "train.call", "train.warmup_call"} <= names


@pytest.mark.parametrize("fault", ["halfbatch", "frozen", "staleema", "shiftcond"])
def test_each_fault_fails_a_check(fault):
    out = train_steps.run(vocoder_ctx(variant=fault))
    assert not all(c.ok for c in out.checks), checks(out)


@pytest.mark.card
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = common.load_cell(CELL)
    for seed in (2 ** 31 + 111, 2 ** 31 + 112):
        ctx = Context(config=c.config, traffic=c.traffic, settings=c.settings, seed=seed,
                      seconds=0.0, trace=False, device="cuda:0", t_start=time.perf_counter(),
                      variant="control")
        assert not all(x.ok for x in train_steps.run(ctx).checks), seed


def test_corpus_checks_find_rows_that_are_no_crop(tmp_path):
    tr = dict(sample_rate=16000, speakers=2, files_per_speaker=2,
              lengths=dict(median_s=0.3, sigma=0.2, min_s=0.25, max_s=0.4))
    train_steps.write_corpus(str(tmp_path), tr, 11, "cpu")
    from port_bench.reference import audio as ref_audio
    with open(tmp_path / "p001" / "utt00.wav", "rb") as f:
        pcm, _ = ref_audio.pcm16_of(f.read())
    data = train_steps.WavCorpus(str(tmp_path), 1024, 256)
    row = (pcm[512:512 + 1024].astype(np.float32) / 32768.0)[None, :, None]
    assert data.rows_off(row) == 0
    off_hop = (pcm[300:300 + 1024].astype(np.float32) / 32768.0)[None, :, None]
    scaled = row * np.float32(0.999)
    assert data.rows_off(np.concatenate([row, off_hop, scaled])) == 2
    audio = common.load_cell(CELL).config["audio"]
    mel = ref_audio.melspectrogram(torch.from_numpy(row[0, :, 0]), audio).T.numpy()[None, :4]
    assert train_steps.cond_err(row, mel, audio) == 0.0
    late = np.concatenate([mel[:, :1], mel[:, :-1]], 1)
    assert train_steps.cond_err(row, late, audio) > 0.01


def reader(name):
    spec = importlib.util.spec_from_file_location(name, common.BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_mfu_of_the_vocoder_step():
    cfg = common.load_cell(CELL).config
    rec = {"steps": 400, "window_s": 50.0, "config": cfg, "trace": None}
    macs = 2 * 7936 * vocoder.sampler_macs(cfg["vocoder"]) + 2 * vocoder.upsample_macs(
        cfg["vocoder"], 31)
    assert 6 * macs == pytest.approx(2.35e12, rel=2e-3)  # a step at the published recipe
    assert reader("mfu.train_vocoder")(rec) == pytest.approx(100 * 6 * macs * 400 / 50.0 / 67e12)
    assert reader("mfu.train_vocoder")(dict(rec, steps=0)) is None
    vae_cfg = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")
    assert reader("mfu.train_vocoder")(dict(rec, config=vae_cfg)) is None


def ema_records(program_spans):
    tr = DeviceTrace()
    # a step's Adam kernel, two EMA kernels (one launched late in the span),
    # then a gap with the span still open
    tr.kernels = [(100, 300, "adam", 1), (400, 450, "mul", 2), (460, 500, "add", 3)]
    tr.launches = {1: (90, 7), 2: (380, 7), 3: (395, 7)}
    return {"trace": tr, "trace_window_ns": (0, 1000), "program_spans": program_spans}


def test_ema_readers():
    ema = {"name": "train.ema", "t0": 370, "t1": 600, "tid": 7}
    opt = {"name": "train.optimizer", "t0": 80, "t1": 360, "tid": 7}
    rec = ema_records([opt, ema])
    assert reader("train.ema_ms")(rec) == pytest.approx(90 / 1e6)      # 400-450 and 460-500
    assert reader("device.idle.train.ema")(rec) == pytest.approx(100 * (30 + 10 + 100) / 1000)
    assert reader("train.adam_ms")(rec) == pytest.approx(200 / 1e6)
    # the parent's program records no span: the readers read nothing
    for name in ("train.ema_ms", "device.idle.train.ema"):
        assert reader(name)(ema_records([])) is None
        assert reader(name)(dict(rec, trace=None)) is None
