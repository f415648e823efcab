"""The share of the traced window, in %, in which no kernel runs while the
trainer ends an epoch: the re-pairing and the loss totals' read-back (the
program's ``train.epoch_tail`` spans)."""

from port_bench.metrics._program import idle_share_in


def read(records: dict):
    return idle_share_in(records, "train.epoch_tail")
