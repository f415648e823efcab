"""The train step's share of the float32 peak: 3 x 2 x the forward's
multiply-adds counted from the configuration's shapes (port_bench/costs/
vae.py), times the steps of the window, over the window."""

from port_bench.costs import PEAK_FLOPS, vae


def read(records: dict):
    steps = records.get("steps")
    if not steps:
        return None
    cfg = records["config"]
    flops = vae.train_step_flops(cfg["vae"], cfg["train"]["batch_size"]) * steps
    return 100.0 * flops / records["window_s"] / PEAK_FLOPS["float32"]
