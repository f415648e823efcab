"""The share of the traced window in which no kernel ran on the device:
the union of the kernels' intervals from torch.profiler.  The traced
window is the serving window whole, or a training cell's recorded steps
(from the first recorded kernel's start to the last one's end)."""

from port_bench.trace import busy_ns


def idle_percent(records: dict):
    trace = records.get("trace")
    if trace is None or not trace.kernels:
        return None
    lo, hi = records["trace_window_ns"]
    return 100.0 * (1.0 - busy_ns(trace, lo, hi) / (hi - lo))
