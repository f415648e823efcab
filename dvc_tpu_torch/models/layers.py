"""Building-block layers (port of dvc_tpu/models/layers.py, serving surface).

The modules keep the reference checkpoints' state-dict names
(model/disentangled_vae.py:90-121: ``linear_layer``, ``conv``), so a
reference ``.pth`` loads with ``load_state_dict``.  Layout is torch's own:
ConvNorm takes (B, C, T) and LinearNorm acts on the last axis.

- ConvNorm / LinearNorm: xavier init (gain 1, the only gain the VAE uses)
  with the reference's bias override (Linear 0.01, Conv 0;
  disentangled_vae.py:22-25).
- BatchNorm: an ``nn.BatchNorm1d`` (same state-dict names) whose train mode
  is dvc_tpu's _GroupedBN (layers.py:140-178): statistics per group of the
  batch; in eval mode it normalizes by the running statistics, exactly as
  dvc_tpu's (layers.py:154-157).  Momentum 0.1 is flax's 0.9.
- LSTM: ``nn.LSTM`` (batch_first); its gate order i, f, g, o is the order
  dvc_tpu's LSTM keeps (layers.py:190-223), so weights carry over as they are.
- flax_init_: flax's default initializers for the vocoders trained in the
  port (lecun-normal conv kernels, zero biases).
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def flax_init_(module: nn.Module) -> nn.Module:
    """Give every ``nn.Conv1d`` below ``module`` flax's ``nn.Conv`` default
    init, in distribution: lecun_normal (a normal truncated at two standard
    deviations, scaled to variance 1/fan_in) and a zero bias.  LayerNorms
    already start at ones and zeros, as flax's; other layers are left as
    they are.  Draws from torch's global RNG."""
    for m in module.modules():
        if isinstance(m, nn.Conv1d):
            fan_in = m.weight.shape[1] * m.weight.shape[2]
            # flax divides by the std of a unit normal truncated at +-2
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


class LinearNorm(nn.Module):
    """Linear with xavier init and bias 0.01 (reference
    model/disentangled_vae.py:90-100 after its init_weights pass)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim)
        nn.init.xavier_uniform_(self.linear_layer.weight)
        nn.init.constant_(self.linear_layer.bias, 0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class ConvNorm(nn.Module):
    """1-D conv with SAME padding (odd kernel), xavier init and bias 0
    (reference model/disentangled_vae.py:103-121); (B, C, T) in and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("ConvNorm needs an odd kernel size")
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)
        nn.init.xavier_uniform_(self.conv.weight)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C, T), with dvc_tpu's (flax) momentum convention.

    Train mode treats the batch as ``groups`` stacked sub-batches (the two
    halves of a pair-fused GVAE pass when groups = 2) and computes, in
    float32, each group's mean and biased variance over (B/groups, T); it
    normalizes each group by its own.  The running statistics move ONCE a
    call, towards the mean over groups of the means and of the biased
    variances times n/(n-1), n = (B/groups)*T.  Calling
    ``nn.BatchNorm1d`` once on the 2B batch (one set of statistics), or
    once per half (two moving-average updates), would each differ from
    dvc_tpu's pair-fused step.  groups = 1 is torch's own train-mode rule."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 groups: int = 1):
        super().__init__(channels, eps=eps, momentum=1.0 - momentum)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        g = self.groups
        b, c, t = x.shape
        if b % g:
            raise ValueError(f"batch {b} does not split into {g} groups")
        xg = x.reshape(g, b // g, c, t).to(torch.float32)
        mean = xg.mean(dim=(1, 3), keepdim=True)                 # (g, 1, C, 1)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, t).to(x.dtype)
        y = y * self.weight[:, None] + self.bias[:, None]
        with torch.no_grad():
            n = (b // g) * t
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.mean(0).flatten(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.mean(0).flatten(),
                                                alpha=m * n / max(n - 1, 1))
            self.num_batches_tracked.add_(1)
        return y
