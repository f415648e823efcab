"""Operations and bytes of the WaveNet MoL vocoder from its configuration.

A copy of the arithmetic of ``bound`` in the port's on-card proof script:
the sampler's multiply-adds a sample step and batch row are
L x (G x (3R + C) + (S + R) x G/2) + S x S + K x S (24,649,216 at the
published widths); the conditioning upsampler adds the transposed
convolutions' multiply-adds.
"""

from __future__ import annotations

from port_bench.costs import HBM_BYTES_PER_S, PEAK_FLOPS


def sampler_macs(voc: dict) -> int:
    """Multiply-adds of one sample step for one batch row."""
    L, R, G = voc["layers"], voc["residual_channels"], voc["gate_channels"]
    S, C, K = voc["skip_out_channels"], voc["cin_channels"], voc["out_channels"]
    return L * (G * (3 * R + C) + (S + R) * (G // 2)) + S * S + K * S


def hop(voc: dict) -> int:
    h = 1
    for s in voc["upsample_scales"]:
        h *= s
    return h


def upsample_macs(voc: dict, frames: int) -> int:
    """Multiply-adds of the ConvTranspose2d stack over ``frames`` mel frames
    of one row: each input element of a stage is scattered over its
    (kf, 2s) kernel."""
    kf, c = voc["freq_axis_kernel_size"], voc["cin_channels"]
    total, t = 0, frames
    for s in voc["upsample_scales"]:
        total += c * t * kf * 2 * s
        t *= s
    return total


def weight_bytes(voc: dict, itemsize: int = 2) -> int:
    """Bytes of the layer and head weights in the served weight type (the
    biases, first conv and final2 in float32)."""
    L, R, G = voc["layers"], voc["residual_channels"], voc["gate_channels"]
    S, C, K = voc["skip_out_channels"], voc["cin_channels"], voc["out_channels"]
    wide = L * (G * (3 * R + C) + (S + R) * (G // 2)) + S * S
    narrow = L * (G + S + R) + 2 * R + S + K * S + K
    return wide * itemsize + narrow * 4


def call_cost(voc: dict, rows: int, frames: int) -> tuple[float, float]:
    """(flops, bytes) of one ``.batch`` call over ``rows`` rows padded to
    ``frames`` frames: the upsampler and the sampler; bytes are the weights
    read once, the conditioning frames in and the samples out."""
    samples = frames * hop(voc)
    flops = 2.0 * rows * (samples * sampler_macs(voc) + upsample_macs(voc, frames))
    nbytes = weight_bytes(voc) + rows * frames * voc["cin_channels"] * 4 + rows * samples * 4
    return flops, float(nbytes)


def least_seconds(voc: dict, rows: int, frames: int) -> float:
    """The least time of one call at the bf16 peak and the memory rate."""
    flops, nbytes = call_cost(voc, rows, frames)
    return max(flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
