"""Collectives of the mesh layer with their autograd rules.

GSPMD derives the transpose of every collective it inserts; here each is
an autograd Function, chosen by who consumes its output:

  all_reduce_sum     forward: the sum over the group; backward: the sum of
                     the gradients (every rank's loss reads the sum);
  all_gather         forward: the group's blocks joined along ``dim``;
                     backward: the gradients summed over the group, this
                     rank's block kept (every rank has its own loss);
  gather_replicated  forward: as all_gather; backward: this rank's block of
                     the gradient alone, for consumers that every rank of
                     the group computes alike (tensor parallelism's
                     replicated layers), whose gradients are already equal;
  reduce_grad        forward: the identity; backward: the gradients summed
                     over the group (the input of a column-parallel layer,
                     whose every block adds to the input's gradient).

A group of one rank, or None, makes each of them the identity.  The
tensors live on the rank's device: gloo takes CPU tensors, NCCL CUDA ones.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.distributed as dist


def group_size(group: Any) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Any) -> int:
    return 0 if group is None else dist.get_rank(group)


def gather_blocks(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The group's equal blocks of ``x`` joined along ``dim`` (no autograd)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _block(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    k = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * k, k)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherReplicated.apply(x, dim, group)


def reduce_grad(x: torch.Tensor, group: Any) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceGrad.apply(x, group)


@torch.no_grad()
def average_grads_(params: Iterable[torch.Tensor], group: Any) -> None:
    """Every ``.grad`` below ``params`` (None skipped) replaced by its mean
    over ``group``: one all-reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(group_size(group))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
