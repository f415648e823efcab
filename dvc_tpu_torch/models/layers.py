"""Building-block layers (port of dvc_tpu/models/layers.py, serving surface).

The modules keep the reference checkpoints' state-dict names
(model/disentangled_vae.py:90-121: ``linear_layer``, ``conv``), so a
reference ``.pth`` loads with ``load_state_dict``.  Layout is torch's own:
ConvNorm takes (B, C, T) and LinearNorm acts on the last axis.

- ConvNorm / LinearNorm: xavier init with the reference's bias override
  (Linear 0.01, Conv 0; disentangled_vae.py:22-25), the VAE's; AutoVC
  asks for a conv gain by name and torch's default bias
  (``bias_init_value`` None), as dvc_tpu's layers do (layers.py:52-98).
- BatchNorm: an ``nn.BatchNorm1d`` (same state-dict names) whose train mode
  is dvc_tpu's _GroupedBN (layers.py:140-178): statistics per group of the
  batch; in eval mode it normalizes by the running statistics, exactly as
  dvc_tpu's (layers.py:154-157).  Momentum 0.1 is flax's 0.9.  Under a
  mesh (``data_group``) the train-mode statistics span the global batch.
- LSTM: ``nn.LSTM`` (batch_first); its gate order i, f, g, o is the order
  dvc_tpu's LSTM keeps (layers.py:190-223), so weights carry over as they are.
- flax_init_: flax's default initializers for the modules the port trains
  from scratch (lecun-normal kernels, zero biases).
- frozen_running_stats: BatchNorms that normalize as in train mode but keep
  their running statistics, for the recomputation of a checkpointed forward.
- running_stats_in_graph: BatchNorms whose updated running statistics carry
  gradient into a later eval-mode call, as dvc_tpu's ``mutable`` statistics
  do when they are fed back to ``apply`` (AutoVC's content term).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Give every ``nn.Conv1d`` and ``nn.Linear`` below ``module`` flax's
    ``nn.Conv`` / ``nn.Dense`` default init, in distribution: lecun_normal
    (a normal truncated at two standard deviations, scaled to variance
    1/fan_in) and a zero bias.  LayerNorms already start at ones and zeros,
    as flax's; other layers are left as they are.  Draws from
    ``generator``, or from torch's global RNG when it is None."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            fan_in = m.weight[0].numel()  # in (Linear), in * k (Conv1d)
            # flax divides by the std of a unit normal truncated at +-2
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """While open, every BatchNorm below ``module`` leaves its running
    statistics (and batch count) as they are; train mode still normalizes
    by the batch's statistics.  The recomputation of a checkpointed forward
    runs under it, so a remat step moves the statistics once, as dvc_tpu's
    pure ``jax.checkpoint`` does."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


@contextlib.contextmanager
def running_stats_in_graph(module: nn.Module):
    """While open, a train-mode BatchNorm below ``module`` computes its
    updated running statistics as tensors that carry gradient and keeps
    them (``graph_stats``); its buffers receive the same values, detached.
    An eval-mode call then normalizes by those tensors, so a loss on it
    differentiates through the statistics into the layers ahead of the
    BatchNorm, as dvc_tpu's does when the ``mutable=["batch_stats"]``
    output of a train call is applied again (nothing stops its gradient;
    layers.py:170-177).  Updating the buffers under ``no_grad`` alone
    drops that path."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.stats_in_graph = True
    try:
        yield
    finally:
        for m in bns:
            m.stats_in_graph = False
            m.graph_stats = None


class LinearNorm(nn.Module):
    """Linear with xavier init and bias 0.01 (reference
    model/disentangled_vae.py:90-100 after its init_weights pass), or
    torch's default bias when ``bias_init_value`` is None."""

    def __init__(self, in_dim: int, out_dim: int, bias_init_value: float | None = 0.01):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim)
        nn.init.xavier_uniform_(self.linear_layer.weight)
        if bias_init_value is not None:
            nn.init.constant_(self.linear_layer.bias, bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class ConvNorm(nn.Module):
    """1-D conv with SAME padding (odd kernel), xavier init of gain
    ``w_init_gain`` and bias 0 (reference model/disentangled_vae.py:103-121),
    or torch's default bias when ``bias_init_value`` is None; (B, C, T) in
    and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 w_init_gain: str = "linear", bias_init_value: float | None = 0.0):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("ConvNorm needs an odd kernel size")
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)
        nn.init.xavier_uniform_(self.conv.weight, gain=nn.init.calculate_gain(w_init_gain))
        if bias_init_value is not None:
            nn.init.constant_(self.conv.bias, bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    """BatchNorm's statistics are float32, as dvc_tpu's, or float64 for a
    float64 input, so that a float64 check resolves what float32 rounds."""
    return torch.promote_types(x.dtype, torch.float32)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C, T), with dvc_tpu's (flax) momentum convention.

    Train mode treats the batch as ``groups`` stacked sub-batches (the two
    halves of a pair-fused GVAE pass when groups = 2) and computes, in
    float32 (float64 for a float64 input: ``stat_dtype``), each group's
    mean and biased variance over (B/groups, T); it
    normalizes each group by its own.  The running statistics move ONCE a
    call, towards the mean over groups of the means and of the biased
    variances times n/(n-1), n = (B/groups)*T.  Calling
    ``nn.BatchNorm1d`` once on the 2B batch (one set of statistics), or
    once per half (two moving-average updates), would each differ from
    dvc_tpu's pair-fused step.  groups = 1 is torch's own train-mode rule.
    ``update_stats`` False (set by frozen_running_stats) skips the update;
    ``stats_in_graph`` (set by running_stats_in_graph) keeps the updated
    statistics in the autograd graph for the next eval-mode call.

    ``data_group`` (set by parallel.tensor.shard_model_): a process group
    over which the batch is sharded, each rank's batch stacking its rows of
    every group.  With more than one rank, train mode takes each group's
    statistics over the global batch, as dvc_tpu's under a mesh: sums and
    counts all-reduced for the mean, then the squared deviations for the
    biased variance, and the backward all-reduces its two sums
    (_GlobalBatchNorm); the running statistics move once a call, equal on
    every rank."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 groups: int = 1):
        super().__init__(channels, eps=eps, momentum=1.0 - momentum)
        self.groups = groups
        self.data_group = None
        self.update_stats = True
        self.stats_in_graph = False
        self.graph_stats: tuple[torch.Tensor, torch.Tensor] | None = None

    def updated_stats(self, mean: torch.Tensor, var: torch.Tensor,
                      n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The running statistics after one update by a batch's mean and
        biased variance over n values, as tensors that carry the batch's
        gradient."""
        m = self.momentum
        return ((1.0 - m) * self.running_mean + m * mean,
                (1.0 - m) * self.running_var + m * var * (n / max(n - 1, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.stats_in_graph and self.graph_stats is not None:
                mean, var = self.graph_stats
                y = (x - mean[:, None]) * torch.rsqrt(var[:, None] + self.eps)
                return y * self.weight[:, None] + self.bias[:, None]
            return super().forward(x)
        g = self.groups
        b, c, t = x.shape
        if b % g:
            raise ValueError(f"batch {b} does not split into {g} groups")
        n = (b // g) * t
        if self.data_group is not None and dist.get_world_size(self.data_group) > 1:
            xhat, mean, var = _GlobalBatchNorm.apply(x, g, self.eps, self.data_group)
            n *= dist.get_world_size(self.data_group)
            y = xhat.to(x.dtype)
        else:
            xg = x.reshape(g, b // g, c, t).to(stat_dtype(x))
            mean = xg.mean(dim=(1, 3), keepdim=True)                 # (g, 1, C, 1)
            var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
            y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, t).to(x.dtype)
        y = y * self.weight[:, None] + self.bias[:, None]
        if not self.update_stats:
            return y
        stats = self.updated_stats(mean.mean(0).flatten(), var.mean(0).flatten(), n)
        if self.stats_in_graph:
            self.graph_stats = stats
        with torch.no_grad():
            self.running_mean.copy_(stats[0])
            self.running_var.copy_(stats[1])
            self.num_batches_tracked.add_(1)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Grouped batch normalization over a batch sharded on ``group``: x
    (b, C, T) holds this rank's rows of each of g groups; returns x
    normalized by each group's global mean and biased variance, (b, C, T),
    and those statistics, (g, 1, C, 1), in stat_dtype."""

    @staticmethod
    def forward(ctx, x, g, eps, group):
        b, c, t = x.shape
        xg = x.reshape(g, b // g, c, t).to(stat_dtype(x))
        count = (b // g) * t * dist.get_world_size(group)
        s = xg.sum(dim=(1, 3), keepdim=True)
        dist.all_reduce(s, group=group)
        mean = s / count
        d = xg - mean
        ss = d.square().sum(dim=(1, 3), keepdim=True)
        dist.all_reduce(ss, group=group)
        var = ss / count
        r = torch.rsqrt(var + eps)
        xhat = d * r
        ctx.save_for_backward(xhat, r)
        ctx.count, ctx.group = count, group
        ctx.mark_non_differentiable(mean, var)
        return xhat.reshape(b, c, t), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, r = ctx.saved_tensors
        g, bg, c, t = xhat.shape
        dy = gy.reshape(g, bg, c, t).to(xhat.dtype)
        sums = torch.stack([dy.sum(dim=(1, 3), keepdim=True),
                            (dy * xhat).sum(dim=(1, 3), keepdim=True)])
        dist.all_reduce(sums, group=ctx.group)
        dx = r * (dy - sums[0] / ctx.count - xhat * (sums[1] / ctx.count))
        return dx.reshape(g * bg, c, t).to(gy.dtype), None, None, None
