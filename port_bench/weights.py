"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes the state dicts (the reference system's parameter
names) and hands the same tensors to the program and to the reference.
One uniform draw in [-1, 1) from a ``torch.Generator`` on the device covers
every weight of a model; each parameter takes its slice, scaled:

  * convolution and linear weights: uniform within Xavier's bound
    sqrt(6 / (fan_in + fan_out)) for the VAE; for the vocoder Laplace
    (double-exponential, heavy-tailed as trained weights are) with the
    standard deviation 1 / sqrt(3 fan_in) of torch's default init, drawn by
    the inverse CDF from the same uniform slice;
  * LSTM weights and biases: 1 / sqrt(hidden);
  * other biases: 0.05 of the unit draw (the VAE) or 1 / sqrt(fan_in);
  * BatchNorm: weight 1, bias 0, running mean 0, running variance 1.

The vocoder's MoL head (final2) is set so that draws spread instead of
clipping at +-1: its logit rows x 3, its mean rows x 0.5, its log-scale
rows x 0.5 with biases near -4 (a logistic scale near 0.018), as a trained
16-bit vocoder's are.  The time of every kernel is independent of these
values; they make the judged trajectories move.
"""

from __future__ import annotations

import math

import torch


def vae_shapes(vae: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every entry of the DisentangledVAE's state
    dict; kind in {"w", "b", "lstm", "bn_w", "bn_b", "bn_mean", "bn_var",
    "bn_n"}."""
    m, e, k, n = vae["num_mels"], vae["enc_channels"], vae["kernel_size"], vae["dim_neck"]
    p, h2, flat = vae["dim_pre"], vae["dec_lstm2_hidden"], vae["frames"] * 2 * vae["dim_neck"]
    spk, lat = vae["speaker_size"], vae["latent_dim"]
    out: list[tuple[str, tuple[int, ...], str]] = []

    def lin(name, i, o):
        out.extend([(f"{name}.weight", (o, i), "w"), (f"{name}.bias", (o,), "b")])

    def conv(name, i, o):
        out.extend([(f"{name}.weight", (o, i, k), "w"), (f"{name}.bias", (o,), "b")])

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
                    (f"{name}.running_mean", (c,), "bn_mean"),
                    (f"{name}.running_var", (c,), "bn_var"),
                    (f"{name}.num_batches_tracked", (), "bn_n")])

    def lstm(name, i, h, layers, dirs):
        for lay in range(layers):
            for sfx in ("", "_reverse")[:dirs]:
                li = i if lay == 0 else h * dirs
                out.extend([(f"{name}.weight_ih_l{lay}{sfx}", (4 * h, li), "lstm"),
                            (f"{name}.weight_hh_l{lay}{sfx}", (4 * h, h), "lstm"),
                            (f"{name}.bias_ih_l{lay}{sfx}", (4 * h,), "lstm"),
                            (f"{name}.bias_hh_l{lay}{sfx}", (4 * h,), "lstm")])

    for i in range(3):
        conv(f"enc_modules.{i}.0.conv", m if i == 0 else e, e)
        bn(f"enc_modules.{i}.1", e)
    lstm("enc_lstm", e, n, vae["enc_lstm_layers"], 2)
    lin("enc_linear.linear_layer", flat, 2048)
    lin("style.linear_layer", 2048, 2 * spk)
    lin("content.linear_layer", 2048, 2 * (lat - spk))
    lin("dec_pre_linear1", lat, 2048)
    lin("dec_pre_linear2", 2048, flat)
    lstm("dec_lstm1", 2 * n, p, 1, 1)
    for i in range(3):
        conv(f"dec_modules.{i}.0", p, p)
        bn(f"dec_modules.{i}.1", p)
    lstm("dec_lstm2", p, h2, 2, 1)
    lin("dec_linear2.linear_layer", h2, m)
    pl, pc = vae["postnet_layers"], vae["postnet_channels"]
    for i in range(pl):
        conv(f"postnet.convolutions.{i}.0.conv", m if i == 0 else pc, m if i == pl - 1 else pc)
        bn(f"postnet.convolutions.{i}.1", m if i == pl - 1 else pc)
    return out


def vocoder_shapes(voc: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of the WaveNet's state dict, the r9y9 names."""
    R, G, S = voc["residual_channels"], voc["gate_channels"], voc["skip_out_channels"]
    C, K, kf = voc["cin_channels"], voc["out_channels"], voc["freq_axis_kernel_size"]
    out = [("first_conv.weight", (R, 1, 1), "w"), ("first_conv.bias", (R,), "b")]
    for li in range(voc["layers"]):
        p = f"conv_layers.{li}."
        out += [(p + "conv.weight", (G, R, voc["kernel_size"]), "w"), (p + "conv.bias", (G,), "b"),
                (p + "conv1x1c.weight", (G, C, 1), "w"),
                (p + "conv1x1_skip.weight", (S, G // 2, 1), "w"), (p + "conv1x1_skip.bias", (S,), "b"),
                (p + "conv1x1_out.weight", (R, G // 2, 1), "w"), (p + "conv1x1_out.bias", (R,), "b")]
    out += [("last_conv_layers.1.weight", (S, S, 1), "w"), ("last_conv_layers.1.bias", (S,), "b"),
            ("last_conv_layers.3.weight", (K, S, 1), "w"), ("last_conv_layers.3.bias", (K,), "b")]
    for j, s in enumerate(voc["upsample_scales"]):
        out += [(f"upsample_conv.{2 * j}.weight", (1, 1, kf, 2 * s), "up_w"),
                (f"upsample_conv.{2 * j}.bias", (1,), "up_b")]
    return out


def _fan(shape) -> tuple[int, int]:
    rf = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * rf, shape[0] * rf


def _make(shapes, seed: int, device, scale_of) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, _ in shapes)
    unit = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd, off = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        sd[name] = scale_of(name, shape, kind, unit[off:off + n].view(shape))
        off += n
    return sd


def vae_state_dict(vae: dict, seed: int, device) -> dict[str, torch.Tensor]:
    def scale(name, shape, kind, u):
        if kind == "w":
            fi, fo = _fan(shape)
            return u * math.sqrt(6.0 / (fi + fo))
        if kind == "lstm":
            return u / math.sqrt(shape[0] // 4)
        if kind == "b":
            return u * 0.05
        if kind in ("bn_w", "bn_var"):
            return torch.ones_like(u)
        if kind == "bn_n":
            return torch.zeros((), dtype=torch.long, device=u.device)
        return torch.zeros_like(u)
    return _make(vae_shapes(vae), seed, device, scale)


def vocoder_state_dict(voc: dict, seed: int, device) -> dict[str, torch.Tensor]:
    K = voc["out_channels"]
    nr = K // 3
    fan_in = {}
    for name, shape, kind in vocoder_shapes(voc):
        if kind == "w":
            fan_in[name.rsplit(".", 1)[0]] = _fan(shape)[0]

    def scale(name, shape, kind, u):
        if kind == "up_w":  # the published upsampler's constant init
            return torch.full_like(u, 1.0 / (shape[2] * shape[3]))
        if kind == "up_b":
            return torch.zeros_like(u)
        std = 1.0 / math.sqrt(3.0 * fan_in[name.rsplit(".", 1)[0]])
        if kind == "w":
            x = -std / math.sqrt(2.0) * torch.sign(u) * torch.log1p(-u.abs().clamp(max=1 - 2 ** -23))
        else:
            x = u * math.sqrt(3.0) * std
        if name.startswith("last_conv_layers.3."):
            gain = torch.ones(K, device=u.device)
            gain[:nr], gain[nr:2 * nr], gain[2 * nr:] = 3.0, 0.5, 0.5
            x = x * gain.view((K,) + (1,) * (x.dim() - 1))
            if kind == "b":
                x = x.clone()
                x[2 * nr:] += -4.0
        return x
    return _make(vocoder_shapes(voc), seed, device, scale)
