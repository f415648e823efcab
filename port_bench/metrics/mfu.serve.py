"""The whole served path's share of the chip's peak: for every drain of
the window, the VAE's operations on its bucketed chunk batch at the
float32 peak plus the vocoder's at the bf16 peak (port_bench/costs), as
least time, over the window from its start to the last reply."""

from port_bench.costs import PEAK_FLOPS, vae, vocoder


def read(records: dict):
    lo, hi = records["window_ns"]
    cfg = records["config"]
    least = 0.0
    n = 0
    for s in records["spans"]:
        if s["name"] != "vocoder.batch" or not lo <= s["t0"] <= hi:
            continue
        nb = 1
        while nb < max(s["chunks"], 1):
            nb <<= 1
        flops, _ = vocoder.call_cost(cfg["vocoder"], s["rows"], s["frames"])
        least += vae.forward_flops(cfg["vae"], nb) / PEAK_FLOPS["float32"]
        least += flops / PEAK_FLOPS["bfloat16"]
        n += 1
    return 100.0 * least / records["window_s"] if n else None
