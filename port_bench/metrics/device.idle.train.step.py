"""The share of the traced window, in %, in which no kernel runs while the
trainer is inside a step's forward, backward or optimizer (the program's
``train.forward``, ``train.backward`` and ``train.optimizer`` spans)."""

from port_bench.metrics._program import idle_share_in


def read(records: dict):
    return idle_share_in(records, "train.forward", "train.backward", "train.optimizer")
