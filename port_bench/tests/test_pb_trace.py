"""The trace reductions and the per-layer readers on synthetic records."""

import importlib.util

import pytest

from port_bench import common
from port_bench.trace import DeviceTrace, breakdown, busy_ns, kernels_of, merged

CFG = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")


def reader(name):
    spec = importlib.util.spec_from_file_location(name, common.BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def synthetic():
    tr = DeviceTrace()
    # two kernels of a vocoder call launched from thread 7, one front-end
    # kernel from thread 9 inside the same span, one outside any span
    tr.kernels = [(100, 400, "sampler", 1), (350, 500, "upsample", 2), (420, 450, "fft", 3),
                  (800, 900, "adam", 4)]
    tr.launches = {1: (90, 7), 2: (95, 7), 3: (96, 9), 4: (700, 5)}
    span = {"name": "vocoder.batch", "t0": 40, "t1": 600, "tid": 7, "ident": 77, "rows": 8,
            "frames": 384, "chunks": 30, "seconds": 0.5}
    return tr, span


def test_union_and_busy():
    tr, _ = synthetic()
    assert merged(tr.kernels, 0, 1000) == [(100, 500), (800, 900)]
    assert busy_ns(tr, 0, 1000) == 500
    assert busy_ns(tr, 450, 850) == 100


def test_kernels_of_a_span_by_thread_then_time():
    tr, span = synthetic()
    assert [k[2] for k in kernels_of(tr, span)] == ["sampler", "upsample"]
    other = dict(span, tid=1, ident=2)  # a trace that names threads otherwise
    assert [k[2] for k in kernels_of(tr, other)] == ["sampler", "upsample", "fft"]


def test_breakdown_labels_gaps_by_the_shortest_covering_span():
    tr, span = synthetic()
    client = {"name": "client.request", "t0": 0, "t1": 1000, "tid": -1}
    out = breakdown(tr, [span, client], 0, 1000)
    assert out["device_ops"][0] == ["sampler", 300 / 1e9]
    assert out["idle_gaps"][0] == ["client.request", 300 / 1e9]   # 500..800
    assert ["vocoder.batch", 100 / 1e9] in out["idle_gaps"]         # 0..100, its middle inside the call
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_serving_readers():
    tr, span = synthetic()
    rec = {"spans": [span], "window_ns": (0, 1000), "trace_window_ns": (0, 1000),
           "window_s": 2.0, "counters": {"requests": 24, "batches": 3}, "config": CFG,
           "trace": tr}
    assert reader("serve.requests_per_batch")(rec) == 8.0
    assert reader("vocoder.s_per_batch")(rec) == 0.5
    from port_bench.costs import vocoder
    assert reader("vocoder_roofline")(rec) == pytest.approx(
        100 * vocoder.least_seconds(CFG["vocoder"], 8, 384) / 400e-9)
    assert reader("device.idle.serve")(rec) == pytest.approx(50.0)
    assert reader("mfu.serve")(rec) > 0
    assert reader("serve.requests_per_batch")(dict(rec, counters={"requests": 0,
                                                                  "batches": 0})) is None
    assert reader("vocoder_roofline")(dict(rec, trace=None)) is None


def test_training_readers():
    rec = {"steps": 300, "window_s": 50.0, "config": CFG, "window_peak_bytes": 3 * 2 ** 30,
           "trace": None, "trace_window_ns": None}
    from port_bench.costs import vae
    assert reader("mfu.train")(rec) == pytest.approx(
        100 * 300 * vae.train_step_flops(CFG["vae"], 256) / 50.0 / 67e12)
    assert reader("device.peak_mem_gib.train")(rec) == 3.0
    assert reader("device.idle.train")(rec) is None
