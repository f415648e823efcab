"""Device-busy ms a step of the kernels launched inside the program's
``train.ema`` (the vocoder trainer's update of its EMA trail): by launch
time, from any thread, the union of their intervals (metrics/_program.py)."""

from port_bench.metrics._program import busy_ms_per_span


def read(records: dict):
    return busy_ms_per_span(records, "train.ema")
