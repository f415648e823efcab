"""What every run shares: the manifest and a cell's files, seeds, the chip
check, the forbidden-module check and the result line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dvc_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the manifest: its configuration's file, its
    traffic mix (``traffic/<traffic>.json``), its settings
    (``workloads/<name>.json``) and the metrics it reports."""
    man = load_json(manifest_path)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{[w['name'] for w in man['workloads']]}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in man["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=entry["chips"], config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
                settings=load_json(BENCH_DIR / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def sub_seeds(seed: int, names: tuple[str, ...]) -> dict[str, int]:
    """Independent 63-bit seeds for each part of a run, from ``--seed``."""
    ss = np.random.SeedSequence(int(seed))
    vals = ss.generate_state(2 * len(names), np.uint32)
    return {n: int(vals[2 * i]) << 31 | int(vals[2 * i + 1]) >> 1 for i, n in enumerate(names)}


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for part ``keys`` of the work that ``seed`` seeds."""
    vals = np.random.SeedSequence([int(seed) % 2 ** 63, *keys]).generate_state(2, np.uint32)
    return int(vals[0]) << 31 | int(vals[1]) >> 1


def forbidden_loaded() -> list[str]:
    """Top-level names of sys.modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def num(x: float) -> float:
    """A metric's number as measured; non-finite numbers are refused."""
    x = float(x)
    if not math.isfinite(x):
        raise ValueError(f"non-finite metric {x}")
    return x


@dataclass
class Check:
    """One number that decides ``correct``: value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: counts, end-to-end metrics, the records
    the per-layer readers read, and the checks."""

    attempted: int
    failed: int
    end_to_end: dict[str, float]
    memory_peak_bytes: int
    checks: list[Check] = field(default_factory=list)
    records: dict = field(default_factory=dict)
    notes: dict = field(default_factory=dict)


class Laps:
    """Seconds of each phase of set-up, for the record on stderr."""

    def __init__(self, t_start: float):
        import time
        self._clock, self._last, self.items = time.perf_counter, t_start, {}

    def __call__(self, name: str) -> None:
        now = self._clock()
        self.items[name] = round(now - self._last, 3)
        self._last = now


def report_checks(checks: list[Check]) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()


def result_line(correct: bool, out: Outcome, metrics: dict[str, dict], device: dict,
                breakdown: dict | None) -> str:
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else str(c.value),
                               "limit": c.limit} for c in out.checks}
    return json.dumps(line)


def scratch_dir(tag: str) -> str:
    """A fresh directory under TMPDIR for this run's corpora."""
    import tempfile
    return tempfile.mkdtemp(prefix=f"port_bench_{tag}_")
