"""Building-block layers (port of dvc_tpu/models/layers.py, serving surface).

The modules keep the reference checkpoints' state-dict names
(model/disentangled_vae.py:90-121: ``linear_layer``, ``conv``), so a
reference ``.pth`` loads with ``load_state_dict``.  Layout is torch's own:
ConvNorm takes (B, C, T) and LinearNorm acts on the last axis.

- ConvNorm / LinearNorm: xavier init (gain 1, the only gain the VAE uses)
  with the reference's bias override (Linear 0.01, Conv 0;
  disentangled_vae.py:22-25).
- BatchNorm: ``nn.BatchNorm1d``; served in eval mode, where it normalizes by
  the running statistics exactly as dvc_tpu's (layers.py:154-157).  Momentum
  0.1 is flax's 0.9.  The pair-fused (grouped) train-mode statistics wait for
  the training slice.
- LSTM: ``nn.LSTM`` (batch_first); its gate order i, f, g, o is the order
  dvc_tpu's LSTM keeps (layers.py:190-223), so weights carry over as they are.
"""

from __future__ import annotations

import torch
from torch import nn


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


def batch_norm(channels: int, momentum: float = 0.9, eps: float = 1e-5) -> nn.BatchNorm1d:
    """torch BatchNorm1d from dvc_tpu's (flax) momentum convention."""
    return nn.BatchNorm1d(channels, eps=eps, momentum=1.0 - momentum)
