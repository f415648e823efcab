"""The share of the traced window, in %, in which no kernel runs while the
vocoder trainer updates its EMA trail (the program's ``train.ema`` span)."""

from port_bench.metrics._program import idle_share_in


def read(records: dict):
    return idle_share_in(records, "train.ema")
