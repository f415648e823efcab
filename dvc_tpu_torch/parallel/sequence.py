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
(models/long_context.py) runs the encoder this way.  Both are
differentiable, as dvc_tpu's are under ``jax.grad``: the halo conv sends
its halos' gradients back to the neighbours, the LSTM relays its carry's
gradient back along the ring, and the replicated weights' gradients are
summed over the axis.

The frames are sharded over the mesh's data axis; a data group of one
rank (or no group) makes each function its one-device self.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.parallel.collectives import group_rank, group_size, reduce_grad
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


_LSTM_WEIGHTS = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def _lstm_chunk(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, weights: dict,
                reverse: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LSTM direction over the chunk x (B, T, I) from the carry (h, c),
    (B, H) each; a reversed direction walks the chunk from its end."""
    if reverse:
        x = x.flip(1)
    lstm = nn.LSTM(x.shape[-1], h.shape[-1], batch_first=True, device="meta")
    out, (h, c) = torch.func.functional_call(lstm, weights, (x, (h[None], c[None])))
    return (out.flip(1) if reverse else out), h[0], c[0]


def _ring(group: Any, reverse: bool) -> tuple[int | None, int | None, int]:
    """(the global rank this shard takes its carry from, the one it hands
    its carry to, the shard that ends the ring); None past either end."""
    n, i = group_size(group), group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    prev, nxt, last = (i + 1, i - 1, 0) if reverse else (i - 1, i + 1, n - 1)
    return (ranks[prev] if 0 <= prev < n else None,
            ranks[nxt] if 0 <= nxt < n else None, ranks[last])


class _RingLSTM(torch.autograd.Function):
    """The carry relay with its transpose.  The forward keeps the local
    chunk's autograd graph where a gradient is wanted; the backward relays
    the carry's gradient the other way round the ring: the last shard
    starts from the sum of every rank's gradient of the broadcast final
    carry, each shard runs its chunk's backward from the gradient it
    receives and its outputs', and hands the gradient of its initial carry
    to the shard that sent it."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b_ih, b_hh, group, reverse, grad_enabled):
        prev, nxt, last = _ring(group, reverse)
        h0 = x.new_zeros((x.shape[0], w_hh.shape[1]))
        c0 = torch.zeros_like(h0)
        if prev is not None:
            dist.recv(h0, prev, group)
            dist.recv(c0, prev, group)
        ins = (x, h0, c0, w_ih, w_hh, b_ih, b_hh)
        keep = grad_enabled and any(ctx.needs_input_grad[:5])
        if keep:
            ins = [t.detach().requires_grad_() for t in ins]
        with torch.set_grad_enabled(keep):
            out, h, c = _lstm_chunk(*ins[:3], dict(zip(_LSTM_WEIGHTS, ins[3:])), reverse)
        ctx.graph = ins, (out, h, c)
        ctx.ring = group, prev, nxt, last
        h, c = h.detach().clone(), c.detach().clone()
        if nxt is not None:
            dist.send(h, nxt, group)
            dist.send(c, nxt, group)
        dist.broadcast(h, last, group)  # the ring's final carry, from its last shard
        dist.broadcast(c, last, group)
        return out.detach(), h, c

    @staticmethod
    def backward(ctx, g_out, g_h, g_c):
        (ins, outs), (group, prev, nxt, last) = ctx.graph, ctx.ring
        del ctx.graph
        g_h, g_c = g_h.contiguous().clone(), g_c.contiguous().clone()
        # the broadcast's transpose: the final carry's gradient summed on its source
        dist.reduce(g_h, last, group=group)
        dist.reduce(g_c, last, group=group)
        if nxt is not None:  # this shard's final carry went on to the next shard
            dist.recv(g_h, nxt, group)
            dist.recv(g_c, nxt, group)
        gx, gh0, gc0, *gw = torch.autograd.grad(outs, ins, (g_out, g_h, g_c))
        if prev is not None:
            dist.send(gh0.contiguous(), prev, group)
            dist.send(gc0.contiguous(), prev, group)
        flat = torch.cat([g.reshape(-1) for g in gw])
        dist.all_reduce(flat, group=group)
        gw = [g.view_as(w) for g, w in zip(flat.split([w.numel() for w in gw]), gw)]
        return (gx, *gw, None, None, None)


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

    The backward returns the gradient of the loss summed over the ranks:
    the carry's gradient is relayed back from shard to shard (shard i
    starts when shard i + 1 is done), the replicated final carry's
    gradients are summed on the shard that computed it, and the weights'
    gradients are summed over the axis, as the halo conv's are.  Under
    no_grad or inference_mode no graph is kept."""
    group = mesh.data_group
    if group_size(group) == 1:
        h = x.new_zeros((x.shape[0], w_hh.shape[1]))
        weights = dict(zip(_LSTM_WEIGHTS, (w_ih, w_hh, b_ih, b_hh)))
        out, h, c = _lstm_chunk(x, h, torch.zeros_like(h), weights, reverse)
        return out, (h, c)
    out, h, c = _RingLSTM.apply(x, w_ih, w_hh, b_ih, b_hh, group, reverse,
                                torch.is_grad_enabled())
    return out, (h, c)


def frame_sharded_encode_conv_stack(x: torch.Tensor, model, mesh: Mesh) -> torch.Tensor:
    """The DisentangledVAE encoder's three conv + BatchNorm + relu layers
    on this rank's frames x (B, n_mels, T_local) of a frame-sharded
    utterance, BatchNorm on its running statistics (position-independent,
    so sharding is exact).  Returns this rank's (B, C, T_local) frames.
    The backward returns the gradient of the loss summed over the ranks:
    the convs' as sequence_sharded_conv1d's, and BatchNorm's scale and
    bias gradients summed over the axis."""
    group = mesh.data_group
    h = x
    for m in model.enc_modules:
        conv, bn = m[0].conv, m[1]
        h = sequence_sharded_conv1d(h, conv.weight, conv.bias, mesh)
        h = F.relu(F.batch_norm(h, bn.running_mean, bn.running_var, reduce_grad(bn.weight, group),
                                reduce_grad(bn.bias, group), training=False, eps=bn.eps))
    return h
