"""The program's own spans in a traced run, and the reductions their
readers share.

The program records spans at its layer boundaries while torch.profiler
records (``dvc_tpu_torch.utils.profiling``: ``name``, ``t0``/``t1`` on the
epoch clock the device trace uses, ``tid``, ``id``, ``parent`` and the
span's attributes).  A run is a process of its own and the profiler records
only over its window, so the program's buffer holds that window's spans
and nothing else; a test hands spans in as ``records["program_spans"]``.
Every reduction keeps the spans that overlap ``records["trace_window_ns"]``
and gives None where the run was not traced or the program recorded no
span (a program without the recorder included).
"""

from __future__ import annotations

import bisect

from port_bench.trace import merged


def _recorded(records: dict) -> list[dict]:
    found = records.get("program_spans")
    if found is not None:
        return found
    try:
        from dvc_tpu_torch.utils.profiling import recorded
    except ImportError:
        return []
    return recorded()


def spans(records: dict, *names: str) -> list[dict] | None:
    """The program's spans named ``names`` that overlap the traced window,
    in order of start; None where the run was not traced or the program
    recorded no span at all."""
    window = records.get("trace_window_ns")
    found = _recorded(records)
    if records.get("trace") is None or window is None or not found:
        return None
    lo, hi = window
    return sorted((s for s in found if s["name"] in names and s["t0"] <= hi and s["t1"] >= lo),
                  key=lambda s: s["t0"])


def mean_ms(records: dict, name: str):
    """The mean duration of the window's spans ``name``, in ms."""
    got = spans(records, name)
    if not got:
        return None
    return sum(s["t1"] - s["t0"] for s in got) / len(got) / 1e6


def busy_ms_per_span(records: dict, name: str):
    """The device-busy ms, a span ``name`` on average, of the kernels whose
    launch ran inside the span on any thread (the autograd engine launches
    a backward's kernels from a thread of its own): the union of those
    kernels' intervals, clipped to the window."""
    got = spans(records, name)
    if not got:
        return None
    trace = records["trace"]
    lo, hi = records["trace_window_ns"]
    launched = sorted((trace.launches[k[3]][0], k) for k in trace.kernels
                      if k[3] in trace.launches)
    times = [t for t, _ in launched]
    busy = 0
    for s in got:
        ks = [k for _, k in launched[bisect.bisect_left(times, s["t0"]):
                                     bisect.bisect_right(times, s["t1"])]]
        busy += sum(b - a for a, b in merged(ks, lo, hi))
    return busy / len(got) / 1e6


def idle_share_in(records: dict, *names: str):
    """The share of the traced window, in %, in which no kernel runs while
    one of the program's spans ``names`` is open."""
    got = spans(records, *names)
    if got is None:
        return None
    trace = records["trace"]
    lo, hi = records["trace_window_ns"]
    runs = merged(trace.kernels, lo, hi)
    edges = [lo] + [x for r in runs for x in r] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    open_ = merged([(s["t0"], s["t1"]) for s in got], lo, hi)
    both, i, j = 0, 0, 0
    while i < len(idle) and j < len(open_):
        a, b = max(idle[i][0], open_[j][0]), min(idle[i][1], open_[j][1])
        both += max(0, b - a)
        if idle[i][1] < open_[j][1]:
            i += 1
        else:
            j += 1
    return 100.0 * both / (hi - lo)
