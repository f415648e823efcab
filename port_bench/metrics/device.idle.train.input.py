"""The share of the traced window, in %, in which no kernel runs while the
trainer waits for a batch or copies it to the device (the program's
``train.data_wait`` and ``train.h2d`` spans)."""

from port_bench.metrics._program import idle_share_in


def read(records: dict):
    return idle_share_in(records, "train.data_wait", "train.h2d")
