#!/usr/bin/env python3
"""The benchmark of dvc_tpu_torch on one or more NVIDIA cards.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's entry in BENCHMARK.json names
its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``);
``workloads/<cell>.json`` holds the cell's settings and the limits of its
checks.  The driver makes the weights and inputs from the seed, warms the
cell's shapes, runs the window and judges the answers against the plain
reference.  With --trace 0 the last line of stdout carries the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, each read by
``metrics/<metric>.py`` from the traced run's records.  The last lines of
stderr give each checked number beside its limit.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), without the program, or when JAX or the JAX package is
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench import common  # noqa: E402


def _reader(name: str):
    path = common.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of the program stay in the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    cell = common.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA card(s); torch sees {n}",
              file=sys.stderr)
        return 2
    try:
        importlib.import_module("dvc_tpu_torch")
    except ImportError as e:
        print(f"port_bench: the program (dvc_tpu_torch) is not here: {e}", file=sys.stderr)
        return 3
    from port_bench.drivers import Context
    driver = importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")
    ctx = Context(config=cell.config, traffic=cell.traffic, settings=cell.settings,
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
                  t_start=T_START)
    out = driver.run(ctx)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = _reader(m["name"])(out.records)
            if v is not None:
                metrics[m["name"]] = {"value": common.num(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": common.num(out.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    trace = out.records.get("trace")
    if trace is not None:
        from port_bench.trace import breakdown as make_breakdown
        from port_bench.trace import busy_ns
        lo, hi = out.records["trace_window_ns"]
        device["busy_s"] = busy_ns(trace, lo, hi) / 1e9
        device["window_s"] = (hi - lo) / 1e9
        breakdown = make_breakdown(trace, out.records["spans"], lo, hi)
        print(f"port_bench: trace of {len(trace.kernels)} kernels, {len(trace.launches)} "
              f"launches, busy {device['busy_s']:.3f} s of {device['window_s']:.3f} s",
              file=sys.stderr)
    print(f"port_bench: end-to-end {out.end_to_end}; set-up {out.notes}", file=sys.stderr)
    print(f"port_bench: {args.workload} seed {args.seed} on {common.card_power_limit()}",
          file=sys.stderr)
    bad = common.forbidden_loaded()
    if bad:
        print(f"port_bench: refusing to report: {bad} loaded in this process", file=sys.stderr)
        return 4
    correct = all(c.ok for c in out.checks)
    common.report_checks(out.checks)
    print(common.result_line(correct, out, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
