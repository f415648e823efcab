"""The vocoder's share of its roofline: the least time of each ``.batch``
call at the chip's published peaks (port_bench/costs/vocoder.py: the
upsampler and 2 x 24,649,216 operations a sample and row at the bf16 peak,
or the weights, frames and samples at the memory rate), over the
device-busy time of the kernels launched inside the call (matched to the
call's span by the launches' correlation ids), summed over the window's
calls."""

from port_bench.costs import vocoder
from port_bench.trace import kernels_of, merged


def read(records: dict):
    trace = records.get("trace")
    if trace is None:
        return None
    lo, hi = records["window_ns"]
    voc = records["config"]["vocoder"]
    least = busy = 0.0
    for s in records["spans"]:
        if s["name"] != "vocoder.batch" or not lo <= s["t0"] <= hi:
            continue
        ks = kernels_of(trace, s)
        if not ks:
            continue
        busy += sum(b - a for a, b in merged(ks, ks[0][0], max(k[1] for k in ks))) / 1e9
        least += vocoder.least_seconds(voc, s["rows"], s["frames"])
    return 100.0 * least / busy if busy > 0 else None
