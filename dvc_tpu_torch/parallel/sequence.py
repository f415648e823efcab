"""Sequence (frame-axis) parallelism (port of dvc_tpu/parallel/sequence.py):
a sharded 1-D convolution with halo exchange, and a sharded LSTM whose
carry is relayed from shard to shard.

The reference converts long utterances as independent 64-frame chunks
(model/variational_base_vae.py:335-348).  Here the frame axis of a
(B, C, T) activation is split over a mesh axis, one block a rank in rank
order; a k-wide convolution trades its (k - 1) // 2-frame halos with the
neighbouring ranks (``dist.batch_isend_irecv``, zeros at the global edges),
so a whole utterance is convolved across ranks with no chunk boundary.
The LSTM runs its input projection on every shard at once and relays only
the (h, c) carry.  ``whole_utterance_encode(mesh=...)``
(models/long_context.py) runs the encoder this way.

The frames are sharded over the mesh's data axis; a data group of one
rank (or no group) makes each function its one-device self.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.parallel.collectives import group_rank, group_size
from dvc_tpu_torch.parallel.mesh import Mesh


def _exchange(to_left: torch.Tensor, to_right: torch.Tensor, group: Any
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_left`` to the previous rank of ``group`` and ``to_right``
    to the next; returns (what the previous sent right, what the next sent
    left), zeros at the ends of the axis."""
    n, i = group_size(group), group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    from_left, from_right = torch.zeros_like(to_right), torch.zeros_like(to_left)
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, to_left.contiguous(), ranks[i - 1], group),
                dist.P2POp(dist.irecv, from_left, ranks[i - 1], group)]
    if i < n - 1:
        ops += [dist.P2POp(dist.isend, to_right.contiguous(), ranks[i + 1], group),
                dist.P2POp(dist.irecv, from_right, ranks[i + 1], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


class _HaloConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, group, halo):
        left, right = _exchange(x[..., :halo], x[..., -halo:], group)
        x_ext = torch.cat([left, x, right], -1)
        ctx.save_for_backward(x_ext, weight)
        ctx.group, ctx.halo, ctx.has_bias = group, halo, bias is not None
        return F.conv1d(x_ext, weight, bias)

    @staticmethod
    def backward(ctx, gy):
        x_ext, weight = ctx.saved_tensors
        group, h = ctx.group, ctx.halo
        gx_ext = torch.nn.grad.conv1d_input(x_ext.shape, weight, gy)
        gw = torch.nn.grad.conv1d_weight(x_ext, weight.shape, gy)
        # the halos' gradients belong to the neighbours' edge frames
        from_left, from_right = _exchange(gx_ext[..., :h], gx_ext[..., -h:], group)
        gx = gx_ext[..., h:-h].clone()
        gx[..., :h] += from_left
        gx[..., -h:] += from_right
        dist.all_reduce(gw, group=group)
        gb = None
        if ctx.has_bias:
            gb = gy.sum(dim=(0, 2))
            dist.all_reduce(gb, group=group)
        return gx, gw, gb, None, None


def sequence_sharded_conv1d(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor | None, mesh: Mesh) -> torch.Tensor:
    """SAME-padded conv1d of this rank's frames x (B, C_in, T_local) of a
    sequence whose frame axis is sharded over the data axis; weight
    (C_out, C_in, k), odd k.  Returns this rank's (B, C_out, T_local)
    frames of the unsharded convolution.  The
    backward returns the gradient of the loss summed over the ranks: the
    halos' gradients go back to their neighbours, and the weight's and
    bias's are summed over the axis, as shard_map's transpose of a
    replicated input is."""
    k = weight.shape[-1]
    if k % 2 != 1:
        raise ValueError("odd kernels only (SAME padding)")
    halo = (k - 1) // 2
    group = mesh.data_group
    if halo == 0 or group_size(group) == 1:
        return F.conv1d(x, weight, bias, padding=halo)
    if x.shape[-1] < halo:
        raise ValueError(f"{x.shape[-1]} frames a rank, fewer than the halo of {halo}")
    return _HaloConv1d.apply(x, weight, bias, group, halo)


def _lstm_chunk(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, weights: dict,
                reverse: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM direction over the chunk x (B, T, I) from the carry (h, c),
    (B, H) each; a reversed direction walks the chunk from its end."""
    if reverse:
        x = x.flip(1)
    lstm = nn.LSTM(x.shape[-1], h.shape[-1], batch_first=True, device="meta")
    out, (h, c) = torch.func.functional_call(lstm, weights, (x, (h[None], c[None])))
    return (out.flip(1) if reverse else out), h[0], c[0]


@torch.no_grad()
def sequence_sharded_lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                          b_ih: torch.Tensor, b_hh: torch.Tensor, mesh: Mesh,
                          reverse: bool = False
                          ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM direction over this rank's frames x (B, T_local, I) of a
    sequence sharded over the data axis; torch's weight layout, (4H, I),
    (4H, H), (4H,), (4H,), gates i, f, g, o.

    Each shard runs its chunk, input projection and recurrence, from the
    carry the previous shard hands it (the next shard when ``reverse``),
    and hands its final carry on: shard i starts when shard i - 1 is done.
    Returns (this rank's outputs (B, T_local, H), (h_T, c_T)), the final
    carry replicated on every rank.

    Forward only: its one caller is the whole-utterance encode, an
    inference path, so it runs without autograd and its outputs carry no
    gradient (the gradient is queued in ROADMAP.md)."""
    group = mesh.data_group
    n, i = group_size(group), group_rank(group)
    weights = {"weight_ih_l0": w_ih, "weight_hh_l0": w_hh, "bias_ih_l0": b_ih,
               "bias_hh_l0": b_hh}
    h = x.new_zeros((x.shape[0], w_hh.shape[1]))
    c = torch.zeros_like(h)
    if n == 1:
        out, h, c = _lstm_chunk(x, h, c, weights, reverse)
        return out, (h, c)
    ranks = dist.get_process_group_ranks(group)
    prev, nxt, last = (i + 1, i - 1, 0) if reverse else (i - 1, i + 1, n - 1)
    if 0 <= prev < n:
        dist.recv(h, ranks[prev], group)
        dist.recv(c, ranks[prev], group)
    out, h, c = _lstm_chunk(x, h, c, weights, reverse)
    h, c = h.contiguous(), c.contiguous()
    if 0 <= nxt < n:
        dist.send(h, ranks[nxt], group)
        dist.send(c, ranks[nxt], group)
    dist.broadcast(h, ranks[last], group)
    dist.broadcast(c, ranks[last], group)
    return out, (h, c)


@torch.no_grad()
def frame_sharded_encode_conv_stack(x: torch.Tensor, model, mesh: Mesh) -> torch.Tensor:
    """The DisentangledVAE encoder's three conv + BatchNorm + relu layers
    on this rank's frames x (B, n_mels, T_local) of a frame-sharded
    utterance, BatchNorm on its running statistics (position-independent,
    so sharding is exact).  Returns this rank's (B, C, T_local) frames."""
    h = x
    for m in model.enc_modules:
        conv, bn = m[0].conv, m[1]
        h = sequence_sharded_conv1d(h, conv.weight, conv.bias, mesh)
        h = F.relu(F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                training=False, eps=bn.eps))
    return h
