"""The sampler kernel's share of a step spent in its 2 L + 1 grid barriers,
in %: the SM cycles of block 0 in the barriers over the cycles of whole
steps, summed over the stamped steps (every step of a launch but its first)
of the window's ``vocoder.sample`` spans, from the stamps the launch writes
while a profiler records.  Cycles over cycles: the clock rate cancels."""

from port_bench.metrics._program import spans


def read(records: dict):
    got = [s for s in spans(records, "vocoder.sample") or () if "step_cycles" in s]
    total = sum(s["step_cycles"] for s in got)
    return 100.0 * sum(s["barrier_cycles"] for s in got) / total if total > 0 else None
