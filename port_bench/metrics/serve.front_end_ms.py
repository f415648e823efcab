"""The mel front end of a request, in ms: the mean of the program's
``serve.front_end`` spans (resample, pad, mel, the copy to the host, so
each ends synchronized)."""

from port_bench.metrics._program import mean_ms


def read(records: dict):
    return mean_ms(records, "serve.front_end")
