#!/usr/bin/env python3
"""The readings that the limits of a cell's checks are set from.

    python3 port_bench/calibrate.py --workload <cell> --seconds <s> \
        --runs none:12,control:3 [--first-seed <n>] [--out <file.jsonl>]

Runs the cell's driver in one process once per seed and variant, each run
with a fresh seed, and prints each run's checked numbers as a JSON line:
``none`` is the program as the configuration states it; ``control`` is
the next lower precision in the program's place (the serving cells: the
program's int8 sampler path and TF32 in the VAE; the training cells: the
reference in TF32); ``halfbatch``, ``frozen``, ``stalecache`` (training) and ``altered``
(serving) plant a fault.  A window of ``--seconds`` (0 for training, whose
readings need none) keeps each run short.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import common  # noqa: E402
from port_bench.drivers import Context  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", default="none:12,control:3")
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    cell = common.load_cell(args.workload)
    driver = importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")
    seed = args.first_seed
    sink = open(args.out, "a") if args.out else None
    for part in args.runs.split(","):
        variant, n = part.split(":")
        for _ in range(int(n)):
            seed += 1
            t = time.perf_counter()
            ctx = Context(config=cell.config, traffic=cell.traffic, settings=cell.settings,
                          seed=seed, seconds=args.seconds, trace=False, device=args.device,
                          t_start=t, variant=None if variant == "none" else variant)
            out = driver.run(ctx)
            line = json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                               "attempted": out.attempted, "failed": out.failed,
                               "seconds": time.perf_counter() - t,
                               "checks": {c.name: c.value for c in out.checks}})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
