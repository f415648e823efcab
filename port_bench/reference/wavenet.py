"""The WaveNet MoL vocoder's served draws, judged in plain PyTorch and NumPy.

The published vocoder (r9y9's wavenet_vocoder as the reference system's
preprocessing/hparams.py:82-117 configures it) at the precision the
configuration states for serving: bf16 weights, activations rounded to
bf16 before every product, float32 sums, the residual and skip chains in
float32, the first conv, biases and final2 in float32.

A served utterance is judged teacher-forced, as a served language model's
tokens are: the reference runs the network once over the served samples
(step t's input is the served sample t - 1) and gets every step's mixture
parameters; it draws the step's uniforms itself, from the counter-based
Philox4x32-10 stream that the serving path documents (key = the 64-bit
seed, counter (word, t, row, 0) for the Gumbel noise, (0, t, row, 1) for
the logistic draw), and forms each mixture's candidate sample.  The served
sample must be one of them, and its mixture must be (to rounding) the
Gumbel-max choice (``judge_draws``).

Kernels that sum in another order than any reference round some bf16
activations the other way at every step, so the draws of a sound program
lie off the reference by a floor of rounding noise; the int8 path lies off
it by about three times that floor.  So the served draws are held to two
references, the served precision and the next lower one: the ratio of
their mean square distances (``draw_ratio``) is small for draws made at
the served precision, large for draws made one precision lower, and near
1 for draws that neither made.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SQRT_HALF = math.sqrt(0.5)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _exact(t: torch.Tensor) -> torch.Tensor:
    return t


def upsample(sd: dict, voc: dict, frames: torch.Tensor) -> torch.Tensor:
    """(B, T_frames, C) mel frames -> (B, T_frames * hop, C): the
    ConvTranspose2d(1, 1, (kf, 2s), stride (1, s), padding ((kf-1)/2, s/2))
    + ReLU stack over a (B, 1, C, T) view."""
    x = frames.transpose(1, 2).unsqueeze(1)
    kf = voc["freq_axis_kernel_size"]
    for j, s in enumerate(voc["upsample_scales"]):
        x = F.relu(F.conv_transpose2d(x, sd[f"upsample_conv.{2 * j}.weight"],
                                      sd[f"upsample_conv.{2 * j}.bias"], stride=(1, s),
                                      padding=((kf - 1) // 2, s // 2)))
    return x.squeeze(1).transpose(1, 2)


def _int8(w: torch.Tensor) -> torch.Tensor:
    """w (out, in) with every output row quantized to int8 codes over its
    inputs (scale = max |w| / 127, round half to even, clip to +-127) and
    dequantized: the per-output-channel symmetric quantization of the
    sampler's int8 weight path."""
    scale = torch.clamp(w.abs().amax(1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def int8_state_dict(sd: dict, voc: dict) -> dict:
    """The layer weights quantized as the next lower precision below bf16
    stores them: each tap of the dilated conv, the conditioning 1x1 and
    each skip / residual 1x1 row quantized per output channel; the rest
    as it is."""
    out = dict(sd)
    for li in range(voc["layers"]):
        p = f"conv_layers.{li}."
        w = sd[p + "conv.weight"]
        out[p + "conv.weight"] = torch.stack([_int8(w[:, :, k]) for k in range(w.shape[2])], 2)
        for name in ("conv1x1c", "conv1x1_skip", "conv1x1_out"):
            out[p + name + ".weight"] = _int8(sd[p + name + ".weight"][:, :, 0])[:, :, None]
    return out


def teacher_forced(sd: dict, voc: dict, cond: torch.Tensor, served: torch.Tensor,
                   weights: str = "bfloat16") -> torch.Tensor:
    """cond (T, C) float32, served (T,) -> y_hat (T, 3K) float32, with the
    roundings of the weight type: "bfloat16" (the served precision on the
    card), "int8" (its next lower one: int8_state_dict's layer weights,
    bf16 activations and final1) or "float32" (the CPU path's, no
    rounding)."""
    rnd = _exact if weights == "float32" else bf16
    if weights == "int8":
        sd = int8_state_dict(sd, voc)
    t_len = cond.shape[0]
    L, R, G = voc["layers"], voc["residual_channels"], voc["gate_channels"]
    S, G2 = voc["skip_out_channels"], voc["gate_channels"] // 2
    per_stack = L // voc["stacks"]
    prev = F.pad(served.float()[:-1], (1, 0))
    h = prev[:, None] * sd["first_conv.weight"][:, 0, 0] + sd["first_conv.bias"]
    c = rnd(cond)
    skip = None
    for li in range(L):
        d = 2 ** (li % per_stack)
        p = f"conv_layers.{li}."
        w = sd[p + "conv.weight"]                                    # (G, R, 3)
        w_in = torch.cat([w[:, :, 0], w[:, :, 1], w[:, :, 2], sd[p + "conv1x1c.weight"][:, :, 0]], 1)
        w_in = w_in if weights == "int8" else rnd(w_in)
        hq = rnd(h)
        tap2, tap1 = (F.pad(hq, (0, 0, k, 0))[:t_len] for k in (2 * d, d))
        pre = torch.cat([tap2, tap1, hq, c], 1) @ w_in.T + sd[p + "conv.bias"]
        gated = rnd(torch.tanh(pre[:, :G2]) * torch.sigmoid(pre[:, G2:]))
        w_so = torch.cat([sd[p + "conv1x1_skip.weight"][:, :, 0],
                          sd[p + "conv1x1_out.weight"][:, :, 0]], 0)
        w_so = w_so if weights == "int8" else rnd(w_so)
        so = gated @ w_so.T + torch.cat([sd[p + "conv1x1_skip.bias"], sd[p + "conv1x1_out.bias"]])
        h = (so[:, S:] + h) * SQRT_HALF
        skip = so[:, :S] if skip is None else (skip + so[:, :S]) * (SQRT_HALF if voc["legacy"] else 1.0)
        del pre, gated, so
    o = F.relu(rnd(F.relu(skip)) @ rnd(sd["last_conv_layers.1.weight"][:, :, 0]).T
               + sd["last_conv_layers.1.bias"])
    return o @ sd["last_conv_layers.3.weight"][:, :, 0].T + sd["last_conv_layers.3.bias"]


_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 over uint64 arrays holding 32-bit words; key = the
    seed's low and high words."""
    c = [np.asarray(x, np.uint64) & _MASK for x in (c0, c1, c2, c3)]
    k0 = np.uint64(seed & 0xFFFFFFFF)
    k1 = np.uint64((seed >> 32) & 0xFFFFFFFF)
    for _ in range(10):
        p0, p1 = _M0 * c[0], _M1 * c[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c


def _uniform01(bits) -> np.ndarray:
    u = (bits >> np.uint64(8)).astype(np.float32) * np.float32(5.9604644775390625e-8) \
        + np.float32(2.98023223876953125e-8)
    return np.clip(u, np.float32(1e-5), np.float32(1.0 - 1e-5))


def uniforms(seed: int, row: int, t_len: int, nr_mix: int) -> tuple[np.ndarray, np.ndarray]:
    """(Gumbel uniforms (T, nr_mix), logistic uniforms (T,)) of batch row
    ``row`` over steps 0..T-1."""
    t = np.arange(t_len, dtype=np.uint64)
    cols = []
    for j in range(-(-nr_mix // 4)):
        words = philox4x32_10(np.full(t_len, j), t, np.full(t_len, row), np.zeros(t_len), seed)
        cols.extend(words)
    gum = np.stack([_uniform01(w) for w in cols[:nr_mix]], 1)
    u = _uniform01(philox4x32_10(np.zeros(t_len), t, np.full(t_len, row), np.ones(t_len),
                                 seed)[0])
    return gum, u


def cpu_stream_uniforms(seed: int, rows: int, t_len: int, nr_mix: int):
    """The uniforms of the CPU path's draws, for every row: a
    torch.Generator seeded with ``seed`` draws (rows, nr_mix) Gumbel
    uniforms then (rows,) logistic ones a step, each mapped to
    [1e-5, 1 - 1e-5].  Returns (T, rows, nr_mix) and (T, rows)."""
    gen = torch.Generator().manual_seed(seed)
    gum, u = [], []
    for _ in range(t_len):
        gum.append(torch.rand((rows, nr_mix), generator=gen) * (1.0 - 2e-5) + 1e-5)
        u.append(torch.rand((rows,), generator=gen) * (1.0 - 2e-5) + 1e-5)
    return torch.stack(gum).numpy(), torch.stack(u).numpy()


def judge_draws(y_hat: torch.Tensor, served: torch.Tensor, gum: np.ndarray, u: np.ndarray,
                log_scale_min: float) -> np.ndarray:
    """The distance (T,) of each served sample from the reference's draw:
    over the mixtures k, the least of |served - candidate_k| + (best score
    - score_k), where score_k is the Gumbel-perturbed logit.  The
    reference's own choice scores 0 in the second term, so a sound draw
    reads the rounding of its candidate; a near-tie that the program broke
    the other way reads the tie's width; a coincidence between candidates
    can only lower the reading."""
    y = y_hat.double().cpu().numpy()
    x = served.double().cpu().numpy()
    nr = y.shape[1] // 3
    gum, u = np.asarray(gum, np.float64), np.asarray(u, np.float64)
    score = y[:, :nr] - np.log(-np.log(gum))
    ls = np.maximum(y[:, 2 * nr:], log_scale_min)
    cand = np.clip(y[:, nr:2 * nr] + np.exp(ls) * (np.log(u) - np.log1p(-u))[:, None], -1.0, 1.0)
    return (np.abs(cand - x[:, None]) + (score.max(1, keepdims=True) - score)).min(1)
