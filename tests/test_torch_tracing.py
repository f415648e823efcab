"""The port's spans (dvc_tpu_torch/utils/profiling.py) on the CPU: the gate
on torch.profiler's flag, nesting and thread ids, the clock shared with the
profiler's own trace, the spans of an HTTP request and of a train epoch,
the sampler's stamp reduction, and the benchmark's readers of them
(port_bench/metrics) on hand-built records."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import importlib.util
import json
import os
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from dvc_tpu_torch import serve
from dvc_tpu_torch.config import Config, TrainConfig, VAEConfig, VocoderConfig
from dvc_tpu_torch.data.dataset import PairedMelDataset
from dvc_tpu_torch.kernels.wavenet_step import generate, stamp_cycles
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.wavenet import WaveNet
from dvc_tpu_torch.train.trainer import Trainer
from dvc_tpu_torch.utils import profiling
from dvc_tpu_torch.utils.wavio import wav_bytes

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from port_bench.trace import DeviceTrace  # noqa: E402

SMALL = dict(frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
             dec_lstm2_hidden=32, postnet_channels=32)
VOC = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16,
           skip_out_channels=8, cin_channels=80, upsample_scales=(2, 2), out_channels=6)


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def by_name(name):
    return [r for r in profiling.recorded() if r["name"] == name]


def test_recording_reads_the_profilers_flag():
    assert profiling.recording() is False
    with cpu_profile():
        assert profiling.recording() is True
        seen = []
        t = threading.Thread(target=lambda: seen.append(profiling.recording()))
        t.start()
        t.join(timeout=10)
        assert seen == [True]  # the flag is process-wide
    assert profiling.recording() is False


def test_nothing_recorded_without_a_profiler():
    with profiling.span("a", x=1) as rec:
        profiling.interval("b", 1, 2)
    assert rec is None
    assert profiling.span("c") is profiling.span("d")  # one shared no-op
    assert profiling.recorded() == []


def test_spans_nest_by_thread():
    def child():
        with profiling.span("worker", k=2):
            pass
    with cpu_profile():
        with profiling.span("outer", k=1) as rec:
            rec["late"] = True
            with profiling.span("inner"):
                t = threading.Thread(target=child)
                t.start()
                t.join(timeout=10)
            profiling.interval("wait", 5, 7, rid=3)
    outer, = by_name("outer")
    inner, = by_name("inner")
    worker, = by_name("worker")
    wait, = by_name("wait")
    assert outer["parent"] is None and outer["k"] == 1 and outer["late"] is True
    assert inner["parent"] == outer["id"] and wait["parent"] == outer["id"]
    assert worker["parent"] is None and worker["k"] == 2  # its own thread's stack
    assert outer["tid"] == inner["tid"] == threading.get_native_id() != worker["tid"]
    assert outer["ident"] == threading.get_ident() & 0xFFFFFFFF
    assert outer["t0"] <= inner["t0"] <= inner["t1"] <= outer["t1"]
    assert (wait["t0"], wait["t1"], wait["rid"]) == (5, 7, 3)
    assert len({r["id"] for r in profiling.recorded()}) == 4


def test_nothing_recorded_in_a_schedules_wait_step():
    with cpu_profile(schedule=schedule(wait=1, warmup=1, active=1, repeat=1)) as prof:
        for step in range(3):
            with profiling.span("step", step=step):
                pass
            prof.step()
    steps = [r["step"] for r in by_name("step")]
    assert 0 not in steps and 2 in steps


def test_spans_share_the_profilers_clock(tmp_path):
    with cpu_profile() as prof:
        with profiling.span("clock.check"):
            time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    ev, = [e for e in data["traceEvents"]
           if e.get("name") == "clock.check" and e.get("cat") == "user_annotation"]
    a = base + int(round(float(ev["ts"]) * 1e3))
    b = a + int(round(float(ev["dur"]) * 1e3))
    rec, = by_name("clock.check")
    assert rec["t0"] - 1_000_000 <= a <= b <= rec["t1"] + 1_000_000
    assert b - a >= 2_000_000
    assert int(ev["tid"]) in (rec["tid"], rec["ident"])


def _mel_tree(root, speakers=("p225", "p226"), utts=6, t_range=(20, 60), seed=0):
    rng = np.random.RandomState(seed)
    for spk in speakers:
        os.makedirs(os.path.join(root, spk), exist_ok=True)
        for u in range(utts):
            np.save(os.path.join(root, spk, f"{spk}_{u:03d}_mel.npy"),
                    rng.rand(80, rng.randint(*t_range)).astype(np.float32))


def test_http_request_spans_share_its_rid(tmp_path):
    _mel_tree(str(tmp_path), utts=2)
    torch.manual_seed(0)
    svc = serve.ConversionService(Config(vae=VAEConfig(**SMALL)),
                                  DisentangledVAE(VAEConfig(**SMALL)), str(tmp_path),
                                  vocoder=None, max_wait_ms=300.0, device="cpu")
    srv = serve.make_http_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}/convert?trg_spk=p226"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    t = np.arange(6400) / 16000
    bodies = [wav_bytes((0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32), 16000)
              for f in (200, 330)]
    status = []

    def post(body):
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=60) as r:
            status.append(r.status)
    try:
        with cpu_profile():
            clients = [threading.Thread(target=post, args=(b,)) for b in bodies]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=60)
        deadline = time.monotonic() + 10
        while len(by_name("serve.reply")) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)  # a handler closes its span after the reply's last byte
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == [200, 200]
    front = {r["rid"]: r for r in by_name("serve.front_end")}
    queued = {r["rid"]: r for r in by_name("serve.queue")}
    reply = {r["rid"]: r for r in by_name("serve.reply")}
    assert len(front) == 2 and front.keys() == queued.keys() == reply.keys()
    vae = by_name("serve.vae")
    assert 1 <= len(vae) <= 2
    for rid, q in queued.items():
        # on one handler thread: the front end, then the wait, then the reply
        assert front[rid]["tid"] == reply[rid]["tid"] != q["tid"]
        assert front[rid]["t1"] <= q["t0"] <= q["t1"] <= reply[rid]["t0"]
        # the wait ends as its drain's work starts, on the worker's thread
        assert any(v["tid"] == q["tid"] and q["t1"] <= v["t0"] <= v["t1"] <= reply[rid]["t0"]
                   for v in vae)
    assert {r["name"] for r in profiling.recorded()} == {
        "serve.front_end", "serve.queue", "serve.vae", "serve.reply"}


def test_train_epoch_spans(tmp_path):
    _mel_tree(str(tmp_path))
    ds = PairedMelDataset(str(tmp_path), samples_length=16, seed=0)
    tr = Trainer(Config(vae=VAEConfig(**SMALL),
                        train=TrainConfig(batch_size=2, compute_dtype="float32")), device="cpu")
    with cpu_profile():
        n = tr.train_epoch(ds, 0)["n_batches"]
    assert n == 3
    for name in ("train.data_wait", "train.h2d", "train.forward", "train.backward",
                 "train.optimizer"):
        assert len(by_name(name)) == n, name
    assert len(by_name("train.epoch_tail")) == 1
    me = threading.get_native_id()
    assert {r["tid"] for r in profiling.recorded()} == {me}
    order = [r["name"] for r in sorted(profiling.recorded(), key=lambda r: r["t0"])]
    assert order[:5] == ["train.data_wait", "train.h2d", "train.forward", "train.backward",
                         "train.optimizer"]
    assert order[-1] == "train.epoch_tail"


def test_vocoder_records_no_span_on_the_cpu_path():
    torch.manual_seed(0)
    model = WaveNet(VocoderConfig(**VOC)).eval()
    frames = torch.rand(2, 3, 80)
    with cpu_profile():
        out = generate(model, frames, seed=1, weight_dtype=torch.float32, device="cpu")
    assert out.shape == (2, 3 * model.hop)
    assert profiling.recorded() == []  # vocoder.sample is the CUDA launch's


def test_sampler_stamps_only_while_a_profiler_records(monkeypatch):
    """wavenet_generate's CUDA branch, with the launch stubbed: no span and
    no stamp or count buffer without a profiler; with one, a
    ``vocoder.sample`` span and every step stamped up to STAMP_STEPS, reduced
    onto the span with the exchange counts."""
    from types import SimpleNamespace

    from dvc_tpu_torch.kernels import wavenet_step as ws
    layers = 2
    asked = []

    def launch(packed, cond, seed, deterministic, checked, stamp_steps):
        asked.append((checked, stamp_steps))
        stamps = torch.arange(stamp_steps * (4 * layers + 4)).reshape(stamp_steps, 4 * layers + 4)
        counts = torch.tensor([5 * (stamp_steps - 1), stamp_steps])
        return "out", None, *((stamps, counts) if stamp_steps else (None, None))
    monkeypatch.setattr(ws, "_launch", launch)
    packed = {"cfg": VocoderConfig(**dict(VOC, layers=layers))}
    cond = SimpleNamespace(device=torch.device("cuda"), shape=(1, 3000, 80))
    assert ws.wavenet_generate(packed, cond) == "out"
    assert profiling.recorded() == []
    with cpu_profile():
        assert ws.wavenet_generate(packed, cond) == "out"
        monkeypatch.setattr(ws, "STAMP_STEPS", 1024)
        assert ws.wavenet_generate(packed, cond) == "out"
    assert asked == [(False, 0), (False, 3000), (False, 1024)]
    whole, capped = by_name("vocoder.sample")
    for rec, steps in ((whole, 3000), (capped, 1024)):
        _, _, stamps, counts = launch(packed, cond, 0, False, False, steps)
        want = stamp_cycles(stamps, layers, counts)
        assert {k: rec[k] for k in want} == want
        assert want["step_cycles"] == (steps - 1) * (4 * layers + 3)  # step 0 left out
        assert (want["exchanges"], want["first_read_exchanges"]) == (5 * (steps - 1), steps)


def test_stamp_cycles_by_hand():
    layers, steps = 2, 4
    nst = 4 * layers + 4
    # each step: phases of 10 cycles, barriers of 3, the step starting 1000
    # later; step 0's first phase waits 500 more (the weights' copies)
    s = np.zeros((steps, nst), np.int64)
    for t in range(steps):
        c = 1000 * t
        s[t, 0] = c
        for k in range(1, nst):
            c += 3 if k in (2, 4, 6, 8, 10) else 10 + 500 * (t == 0 and k == 1)
            s[t, k] = c
    got = stamp_cycles(torch.from_numpy(s), layers)
    assert got == {"barrier_cycles": 3 * 5 * 3, "step_cycles": 3 * (5 * 3 + 6 * 10)}


@pytest.mark.parametrize("layers", [2, 3])
def test_stamp_cycles_reads_the_exchange_waits(layers):
    """The stamps as the kernel writes them without grid barriers: per
    layer, phase in ends when its gated is published (4 l + 1), the wait
    ends when every gated word has arrived (4 l + 2), phase out ends with
    h or the skip sum published (4 l + 3), the next wait when those words
    have arrived (4 l + 4, which opens the next phase); then final1's fin
    (4 L + 1), fin's arrival (4 L + 2), the head (4 L + 3).  Waits of 7
    cycles on gated, 5 on h, 11 on the skip sum and 13 on fin, phases of
    20; step 0's weights copy left out; the counts come through as given."""
    steps, nst = 5, 4 * layers + 4
    wait = {2: 7, 4: 5, 4 * layers: 11, 4 * layers + 2: 13}
    s = np.zeros((steps, nst), np.int64)
    for t in range(steps):
        c = s[t, 0] = 10_000 * t
        for k in range(1, nst):
            is_wait = k % 2 == 0 and k <= 4 * layers + 2
            c += (wait.get(k, wait[2] if k % 4 == 2 else wait[4]) if is_wait
                  else 20 + 900 * (t == 0 and k == 1))
            s[t, k] = c
    got = stamp_cycles(torch.from_numpy(s), layers, torch.tensor([7 * steps, 3]))
    per_step_waits = layers * 7 + (layers - 1) * 5 + 11 + 13
    assert got["barrier_cycles"] == (steps - 1) * per_step_waits
    assert got["step_cycles"] == (steps - 1) * (per_step_waits + 20 * (2 * layers + 2))
    assert (got["exchanges"], got["first_read_exchanges"]) == (7 * steps, 3)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "port_bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def train_records():
    """Two steps and an epoch's tail in a window of 1,000 ns; the backward's
    kernels are launched from another thread (the autograd engine's), and
    a forward before the window is left out."""
    tr = DeviceTrace()
    tr.kernels = [(-80, -10, "z", 0), (150, 250, "a", 1), (250, 300, "b", 2),
                  (300, 380, "c", 3), (380, 390, "d", 4), (420, 440, "e", 5),
                  (600, 700, "f", 6), (900, 950, "g", 7)]
    tr.launches = {0: (-90, 1), 1: (110, 1), 2: (120, 1), 3: (210, 2), 4: (220, 2),
                   5: (410, 1), 6: (570, 1), 7: (810, 1)}

    def s(name, t0, t1):
        return {"name": name, "t0": t0, "t1": t1, "tid": 1, "ident": 11, "id": t0,
                "parent": None}
    spans = [s("train.forward", -100, -5), s("train.forward", 100, 200),
             s("train.backward", 200, 400), s("train.optimizer", 400, 450),
             s("train.data_wait", 460, 500), s("train.h2d", 500, 560),
             s("train.forward", 560, 700), s("train.epoch_tail", 700, 800)]
    return {"trace": tr, "trace_window_ns": (0, 1000), "program_spans": spans}


def test_training_readers_by_hand():
    rec = train_records()
    # forward: a + b (150 ns) and f (100 ns); the one before the window left out
    assert reader("train.fwd_ms")(rec) == pytest.approx(125e-6)
    assert reader("train.bwd_ms")(rec) == pytest.approx(90e-6)   # c + d, another thread
    assert reader("train.adam_ms")(rec) == pytest.approx(20e-6)
    assert reader("train.data_wait_ms")(rec) == pytest.approx(40e-6)
    # idle: 0-150, 390-420, 440-600, 700-900, 950-1000 (59%)
    assert reader("device.idle.train")(rec) == pytest.approx(59.0)
    assert reader("device.idle.train.input")(rec) == pytest.approx(10.0)       # 460-560
    # 100-150, 390-420, 440-450, 560-600
    assert reader("device.idle.train.step")(rec) == pytest.approx(13.0)
    assert reader("device.idle.train.epoch_tail")(rec) == pytest.approx(10.0)  # 700-800


def test_serving_readers_by_hand():
    ms = 1_000_000

    def s(name, t0, t1, **kw):
        return {"name": name, "t0": t0 * ms, "t1": t1 * ms, "tid": 1, "id": t0,
                "parent": None, **kw}
    spans = [s("serve.queue", 10, 22, rid=1), s("serve.queue", 40, 48, rid=2),
             s("serve.front_end", 4, 9, rid=1), s("serve.front_end", 30, 33, rid=2),
             s("serve.vae", 23, 30), s("serve.reply", 60, 61, rid=1),
             s("serve.reply", 90, 93, rid=2),
             s("vocoder.sample", 31, 55, barrier_cycles=30, step_cycles=100, exchanges=98,
               first_read_exchanges=9),
             s("vocoder.sample", 60, 85, barrier_cycles=50, step_cycles=100, exchanges=98,
               first_read_exchanges=40),
             s("vocoder.sample", 86, 87), s("serve.queue", 2000, 2010, rid=3)]
    rec = {"trace": DeviceTrace(), "trace_window_ns": (0, 1000 * ms), "program_spans": spans}
    assert reader("serve.queue_wait_ms")(rec) == pytest.approx(10.0)
    assert reader("serve.front_end_ms")(rec) == pytest.approx(4.0)
    assert reader("serve.vae_ms")(rec) == pytest.approx(7.0)
    assert reader("serve.reply_ms")(rec) == pytest.approx(2.0)
    assert reader("sampler.barrier_share")(rec) == pytest.approx(40.0)
    assert reader("sampler.first_read_share")(rec) == pytest.approx(25.0)
    old = [dict(x) for x in spans]  # a program whose launches count no exchanges
    for x in old:
        x.pop("exchanges", None)
        x.pop("first_read_exchanges", None)
    assert reader("sampler.first_read_share")(dict(rec, program_spans=old)) is None


@pytest.mark.parametrize("name", ["serve.queue_wait_ms", "serve.front_end_ms", "serve.vae_ms",
                                  "serve.reply_ms", "sampler.barrier_share",
                                  "sampler.first_read_share",
                                  "train.data_wait_ms", "train.fwd_ms", "train.bwd_ms",
                                  "train.adam_ms", "device.idle.train.input",
                                  "device.idle.train.step", "device.idle.train.epoch_tail"])
def test_readers_give_none_without_a_trace_or_spans(name):
    rec = train_records()
    assert reader(name)(dict(rec, trace=None)) is None
    assert reader(name)(dict(rec, trace_window_ns=None)) is None
    assert reader(name)(dict(rec, program_spans=[])) is None
