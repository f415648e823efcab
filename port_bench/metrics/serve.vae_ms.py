"""The VAE's part of a drain, in ms: the mean of the program's
``serve.vae`` spans (styles, chunking, the bucketed encode, decode and
postnet, and the copy of the converted mels to the host)."""

from port_bench.metrics._program import mean_ms


def read(records: dict):
    return mean_ms(records, "serve.vae")
