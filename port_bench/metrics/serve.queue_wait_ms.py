"""A request's wait in the service's queue, in ms: the mean over the
window's requests of the program's ``serve.queue`` spans, from entering the
queue to the start of its drain's work (the batching window included)."""

from port_bench.metrics._program import mean_ms


def read(records: dict):
    return mean_ms(records, "serve.queue")
