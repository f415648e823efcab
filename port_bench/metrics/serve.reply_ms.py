"""A reply, in ms: the mean of the program's ``serve.reply`` spans (the
wav's encoding and its write to the socket)."""

from port_bench.metrics._program import mean_ms


def read(records: dict):
    return mean_ms(records, "serve.reply")
