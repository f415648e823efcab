"""The trainer's wait for a batch, in ms: the mean of the program's
``train.data_wait`` spans, the consumer's wait on ``prefetch``'s queue (an
epoch's first includes its new thread's first batch)."""

from port_bench.metrics._program import mean_ms


def read(records: dict):
    return mean_ms(records, "train.data_wait")
