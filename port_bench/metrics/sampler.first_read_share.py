"""The sampler kernel's exchanges whose words had all arrived when block 0
first read them, in % of its exchanges: summed over the stamped steps
(every step of a launch but its first) of the window's ``vocoder.sample``
spans, from the counts the launch keeps while a profiler records.  High:
the readers find the data there; low: they wait on the producers, and the
exchange's cost is its latency.  None from a program whose launches count
no exchanges."""

from port_bench.metrics._program import spans


def read(records: dict):
    got = [s for s in spans(records, "vocoder.sample") or () if "exchanges" in s]
    total = sum(s["exchanges"] for s in got)
    return 100.0 * sum(s["first_read_exchanges"] for s in got) / total if total > 0 else None
