"""Multiply-adds of the DisentangledVAE from its configuration.

Convolutions, LSTMs and the per-frame linear run once a frame; the
flattening linears (enc_linear, style, content, dec_pre_linear1/2) once a
sequence.  LSTMs count 4H(I + H) a frame, layer and direction (the gates'
two matmuls), as ``lstm_macs`` in the port's on-card proof script does; the
elementwise work is not counted.  At the published widths and 256 pairs of
64 frames a train step (3 x 2 x the forward) is 5.52 TFLOP, 82.4 ms at the
float32 peak.
"""

from __future__ import annotations

from port_bench.costs import PEAK_FLOPS


def _lstm(i: int, h: int, layers: int, dirs: int) -> int:
    return sum(4 * h * ((i if k == 0 else h * dirs) + h) * dirs for k in range(layers))


def frame_macs(vae: dict) -> int:
    """Multiply-adds a frame of encode + decode + postnet."""
    m, e, k = vae["num_mels"], vae["enc_channels"], vae["kernel_size"]
    p, n = vae["dim_pre"], vae["dim_neck"]
    pc, pl = vae["postnet_channels"], vae["postnet_layers"]
    enc = m * e * k + 2 * e * e * k + _lstm(e, n, vae["enc_lstm_layers"], 2)
    dec = (_lstm(2 * n, p, 1, 1) + 3 * p * p * k
           + _lstm(p, vae["dec_lstm2_hidden"], 2, 1) + vae["dec_lstm2_hidden"] * m)
    post = 2 * m * pc * k + (pl - 2) * pc * pc * k
    return enc + dec + post


def sequence_macs(vae: dict) -> int:
    """Multiply-adds a sequence of the flattening linears."""
    flat = vae["frames"] * 2 * vae["dim_neck"]
    latent, spk = vae["latent_dim"], vae["speaker_size"]
    return flat * 2048 + 2048 * 2 * spk + 2048 * 2 * (latent - spk) + latent * 2048 + 2048 * flat


def forward_flops(vae: dict, sequences: int) -> float:
    """Operations of one forward pass over ``sequences`` sequences of
    ``frames`` frames."""
    return 2.0 * sequences * (vae["frames"] * frame_macs(vae) + sequence_macs(vae))


def train_step_flops(vae: dict, batch: int) -> float:
    """A pair train step: the forward over 2 x batch sequences, and its
    backward at twice the forward."""
    return 3.0 * forward_flops(vae, 2 * batch)


def train_step_bound_s(vae: dict, batch: int) -> float:
    return train_step_flops(vae, batch) / PEAK_FLOPS["float32"]
