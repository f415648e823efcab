"""WaveNet vocoder (mixture-of-logistics, mel-conditioned) — port of
dvc_tpu/models/wavenet.py.

Module and parameter names are those of the r9y9 ``wavenet_vocoder``
checkpoint the reference publishes (first_conv, conv_layers.{i}.{conv,
conv1x1c,conv1x1_skip,conv1x1_out}, last_conv_layers.{1,3},
upsample_conv.{2j}); weight norm is fused at load (convert/vocode.py).
Public functions keep dvc_tpu's (B, T, C) layout so tests compare like with
like; inside, convolutions run in torch's (B, C, T).

  * WaveNet          — teacher-forced forward and the conditioning upsampler;
  * sample_from_mol  — the MoL head's sampler.
The autoregressive sampler (the CUDA kernel and its plain PyTorch version)
lives in kernels/wavenet_step.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.config import VocoderConfig

SQRT_HALF = math.sqrt(0.5)


class _ResidualGLU(nn.Module):
    """One causal dilated gated layer with residual and skip outputs."""

    def __init__(self, cfg: VocoderConfig, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.pad = (cfg.kernel_size - 1) * dilation  # causal left pad
        g2 = cfg.gate_channels // 2
        self.conv = nn.Conv1d(cfg.residual_channels, cfg.gate_channels,
                              cfg.kernel_size, dilation=dilation)
        self.conv1x1c = nn.Conv1d(cfg.cin_channels, cfg.gate_channels, 1,
                                  bias=False)
        self.conv1x1_skip = nn.Conv1d(g2, cfg.skip_out_channels, 1)
        self.conv1x1_out = nn.Conv1d(g2, cfg.residual_channels, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        # x (B, R, T), c (B, C, T) -> ((B, R, T) residual out, (B, S, T) skip)
        h = self.conv(F.pad(x, (self.pad, 0))) + self.conv1x1c(c)
        a, g = h.chunk(2, dim=1)
        out = torch.tanh(a) * torch.sigmoid(g)
        return (self.conv1x1_out(out) + x) * SQRT_HALF, self.conv1x1_skip(out)


class WaveNet(nn.Module):
    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.first_conv = nn.Conv1d(1, cfg.residual_channels, 1)
        self.conv_layers = nn.ModuleList(
            _ResidualGLU(cfg, cfg.dilation(i)) for i in range(cfg.layers))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(),
            nn.Conv1d(cfg.skip_out_channels, cfg.skip_out_channels, 1),
            nn.ReLU(),
            nn.Conv1d(cfg.skip_out_channels, cfg.out_channels, 1)])
        kf = cfg.freq_axis_kernel_size
        ups: list[nn.Module] = []
        for s in cfg.upsample_scales:
            # reference stack: ConvTranspose2d(1, 1, (kf, 2s), stride (1, s),
            # pad (1, s//2)) + ReLU over a (B, 1, C, T) view — dvc_tpu's
            # banded time-axis conv is the same math
            up = nn.ConvTranspose2d(1, 1, (kf, 2 * s), stride=(1, s),
                                    padding=((kf - 1) // 2, s // 2))
            nn.init.constant_(up.weight, 1.0 / (2 * s * kf))
            nn.init.zeros_(up.bias)
            ups += [up, nn.ReLU()]
        self.upsample_conv = nn.ModuleList(ups)

    @property
    def hop(self) -> int:
        return math.prod(self.cfg.upsample_scales)

    def upsample(self, c: torch.Tensor) -> torch.Tensor:
        """(B, T_frames, C) -> (B, T_frames * hop, C)."""
        x = c.transpose(1, 2).unsqueeze(1)  # (B, 1, C, T)
        for m in self.upsample_conv:
            x = m(x)
        return x.squeeze(1).transpose(1, 2)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                upsample_cond: bool = True) -> torch.Tensor:
        """Teacher-forced forward: x (B, T, 1) waveform, c (B, T_frames, C)
        (or (B, T, C) with upsample_cond=False) -> (B, T, out_channels)."""
        if upsample_cond:
            c = self.upsample(c)
        if c.shape[1] != x.shape[1]:
            raise ValueError(f"conditioning {tuple(c.shape)} does not cover "
                             f"waveform {tuple(x.shape)}")
        h = self.first_conv(x.transpose(1, 2))
        c = c.transpose(1, 2)
        skips = None
        scale = SQRT_HALF if self.cfg.legacy else 1.0
        for layer in self.conv_layers:
            h, s = layer(h, c)
            skips = s if skips is None else (skips + s) * scale
        out = F.relu(self.last_conv_layers[1](F.relu(skips)))
        return self.last_conv_layers[3](out).transpose(1, 2)


# --- mixture of logistics ----------------------------------------------------

def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    # jax.random.uniform(minval=1e-5, maxval=1-1e-5)
    u = torch.rand(shape, generator=generator, device=device)
    return u * (1.0 - 2e-5) + 1e-5


def sample_from_mol(y_hat: torch.Tensor, generator: torch.Generator,
                    log_scale_min: float = -32.23619130191664) -> torch.Tensor:
    """Sample waveform values from MoL parameters (..., 3K) -> (...,):
    Gumbel-max mixture choice, then the logistic inverse CDF."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    g = -torch.log(-torch.log(_uniform(logit_probs.shape, generator, y_hat.device)))
    sel = F.one_hot(torch.argmax(logit_probs + g, dim=-1), nr_mix).to(y_hat.dtype)
    means = torch.sum(y_hat[..., nr_mix:2 * nr_mix] * sel, dim=-1)
    log_scales = torch.clamp(torch.sum(y_hat[..., 2 * nr_mix:] * sel, dim=-1),
                             min=log_scale_min)
    u = _uniform(means.shape, generator, y_hat.device)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)

