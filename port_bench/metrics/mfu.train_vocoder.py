"""The vocoder's train step's share of the float32 peak: 3 x 2 x (the
samples of a step x the WaveNet's multiply-adds a sample, plus the rows x
the upsampler's over their frames; port_bench/costs/vocoder.py), times
the steps of the window, over the window.  A step at the published recipe
is 2 x 7,936 samples and 31 frames a row: 2.35 TFLOP."""

from port_bench.costs import PEAK_FLOPS, vocoder


def read(records: dict):
    steps = records.get("steps")
    cfg = records.get("config") or {}
    voc, train = cfg.get("vocoder"), cfg.get("train") or {}
    if not steps or voc is None or "max_time_steps" not in train:
        return None
    rows = train["batch_size"]
    frames = train["max_time_steps"] // vocoder.hop(voc)
    macs = rows * frames * vocoder.hop(voc) * vocoder.sampler_macs(voc) \
        + rows * vocoder.upsample_macs(voc, frames)
    return 100.0 * 6 * macs * steps / records["window_s"] / PEAK_FLOPS["float32"]
