"""The traced run: torch.profiler over the window, the harness's own spans,
and the reductions every reader shares.

The profiler records the device's kernels and the runtime calls that
launched them (CUPTI activity, process-wide).  The harness records its
spans itself, on the epoch clock (``time.time_ns``) with the native id of
the thread that ran them, around its calls into the program; a kernel
belongs to a span when the call that launched it ran on the span's thread
inside the span (matched by the launch's correlation id, never by a
kernel's name).  Timestamps of the trace are the trace's base time plus
each event's offset, on the same epoch clock.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager

import torch


class Spans:
    """Host-clock spans, appended from any thread."""

    def __init__(self):
        self.items: list[dict] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **attrs):
        t0 = time.time_ns()
        rec = {"name": name, "t0": t0, "tid": threading.get_native_id(),
               "ident": threading.get_ident() & 0xFFFFFFFF, **attrs}
        try:
            yield rec
        finally:
            rec["t1"] = time.time_ns()
            with self._lock:
                self.items.append(rec)


class DeviceTrace:
    """torch.profiler over a window; ``kernels`` [(t0, t1, name, corr)] and
    ``launches`` {corr: (t, tid)} in epoch nanoseconds after stop().

    With ``wait`` and ``active``, only the steps ``wait + 1`` to ``wait +
    active`` (0-based, counted by ``step()`` calls made after each step)
    are recorded: a bounded trace of a long window of short steps."""

    def __init__(self, wait: int | None = None, active: int | None = None):
        self.kernels: list[tuple[int, int, str, int]] = []
        self.launches: dict[int, tuple[int, int]] = {}
        self._prof = None
        self._sched = (wait, active)

    def start(self) -> None:
        kw = {}
        try:  # record the launches of every thread where the profiler offers it
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            pass
        wait, active = self._sched
        if wait is not None:
            kw["schedule"] = torch.profiler.schedule(wait=wait, warmup=1, active=active,
                                                     repeat=1)
            kw["on_trace_ready"] = self._collect
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA], **kw)
        self._prof.__enter__()

    def step(self) -> None:
        if self._prof is not None:
            self._prof.step()

    def stop(self) -> None:
        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if self._sched[0] is None:
            self._collect(prof)

    def window(self) -> tuple[int, int]:
        """From the first recorded kernel's start to the last one's end."""
        return self.kernels[0][0], max(k[1] for k in self.kernels)

    def _collect(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        base = int(data.get("baseTimeNanoseconds", 0))
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            t0 = base + int(round(float(e["ts"]) * 1e3))
            if cat == "kernel":
                self.kernels.append((t0, t0 + int(round(float(e.get("dur", 0)) * 1e3)),
                                     e.get("name", "?"), corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                self.launches[corr] = (t0, int(e.get("tid", -1)))
        self.kernels.sort()


def merged(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of intervals clipped to [lo, hi], as disjoint sorted runs."""
    out: list[list[int]] = []
    for a, b, *_ in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(trace: DeviceTrace, lo: int, hi: int) -> int:
    return sum(b - a for a, b in merged(trace.kernels, lo, hi))


def kernels_of(trace: DeviceTrace, span: dict) -> list[tuple[int, int, str, int]]:
    """The kernels launched while the span was open, from the span's thread
    where the trace names the launching thread by its native id or by the
    low word of its pthread id (the profiler's builds differ); by time
    alone where it names it by neither."""
    ids = {span["tid"], span.get("ident")}
    found = []
    for k in trace.kernels:
        launch = trace.launches.get(k[3])
        if launch is not None and span["t0"] <= launch[0] <= span["t1"]:
            found.append((k, launch[1]))
    mine = [k for k, tid in found if tid in ids]
    return mine if mine else [k for k, _ in found]


def breakdown(trace: DeviceTrace, spans: list[dict], lo: int, hi: int) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by the harness span open at the gap's middle (the
    shortest one that covers it)."""
    per: dict[str, int] = {}
    for a, b, name, _ in trace.kernels:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            per[name] = per.get(name, 0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    runs = merged(trace.kernels, lo, hi)
    edges = [lo] + [x for r in runs for x in r] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        cover = [s for s in spans if s["t0"] <= mid <= s.get("t1", mid)]
        label = min(cover, key=lambda s: s["t1"] - s["t0"])["name"] if cover else "no harness span"
        named.append([label, (b - a) / 1e9])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops], "idle_gaps": named}
