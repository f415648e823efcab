"""Tensor parallelism and the ZeRO optimizer of the mesh trainer.

``shard_model_`` swaps every Linear, Conv1d and LSTM whose weight
``param_sharding_for`` shards over the model axis for its column-parallel
counterpart, keeping the state-dict names and the parameter order:

  ColumnParallelLinear / ColumnParallelConv1d  hold this rank's slice of the
      output features; the input's gradient is summed over the model axis
      (reduce_grad), the output slices joined by gather_replicated, and the
      whole bias, replicated, added after;
  ShardedLSTM  holds its model-sharded weights' blocks (the input features,
      torch dim 1) and gathers them before the original LSTM runs whole.

Every layer after a gather computes alike on each rank of the model axis,
so a replicated parameter's gradient is the same there, and a sharded
one's is its slice of the whole gradient.

``MeshAdam`` is torch's Adam over a mesh: before the update it averages the
gradients, the model-sharded parameters' over the data axis and the others'
over the whole mesh (the same mean, the model axis holding equal copies,
and it keeps the replicas equal); with ZeRO placements each rank keeps
Adam's moments, and updates, only its data-axis block of a parameter, then
gathers the updated blocks.  ``gather_full_`` and ``scatter_full_`` move
weights and Adam's state between the shards and a whole model and Adam on
one rank, for the checkpoints one process writes and reads.
"""

from __future__ import annotations

import copy
from typing import Iterable, Iterator, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.models.layers import BatchNorm
from dvc_tpu_torch.parallel.collectives import (average_grads_, gather_blocks,
                                                gather_replicated, reduce_grad)
from dvc_tpu_torch.parallel.mesh import Mesh, Shard


def _model_dim(placement: tuple) -> int | None:
    p = placement[1]
    return p.dim if isinstance(p, Shard) else None


def _data_dim(placement: tuple) -> int | None:
    p = placement[0]
    return p.dim if isinstance(p, Shard) else None


def _block_of(t: torch.Tensor, dim: int | None, n: int, i: int) -> torch.Tensor:
    if dim is None:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k)


class ColumnParallelLinear(nn.Module):
    """nn.Linear with this rank's rows of the weight (its output features)."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.weight = nn.Parameter(_block_of(linear.weight.detach(), 0, mesh.mp,
                                             mesh.model_index).clone())
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gather_replicated(F.linear(reduce_grad(x, self.group), self.weight), -1, self.group)
        return y if self.bias is None else y + self.bias


class ColumnParallelConv1d(nn.Module):
    """nn.Conv1d with this rank's output channels of the weight."""

    def __init__(self, conv: nn.Conv1d, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = nn.Parameter(_block_of(conv.weight.detach(), 0, mesh.mp,
                                             mesh.model_index).clone())
        self.bias = None if conv.bias is None else nn.Parameter(conv.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(reduce_grad(x, self.group), self.weight, None, self.stride,
                     self.padding, self.dilation)
        y = gather_replicated(y, 1, self.group)
        return y if self.bias is None else y + self.bias[:, None]


class ShardedLSTM(nn.Module):
    """nn.LSTM whose model-sharded weights hold this rank's block; the
    forward gathers them and runs the whole LSTM, a weightless (meta)
    copy of the original, on them through torch.func.functional_call."""

    def __init__(self, lstm: nn.LSTM, mesh: Mesh, dims: Mapping[str, int | None]):
        super().__init__()
        self.group = mesh.model_group
        self.dims = {n: dims.get(n) for n, _ in lstm.named_parameters(recurse=False)}
        for n, w in lstm.named_parameters(recurse=False):
            self.register_parameter(n, nn.Parameter(
                _block_of(w.detach(), self.dims[n], mesh.mp, mesh.model_index).clone()))
        # kept out of the module tree: its parameters are the gathered ones
        self.__dict__["lstm"] = copy.deepcopy(lstm).to("meta")

    def forward(self, x: torch.Tensor, hx=None):
        weights = {n: getattr(self, n) if d is None
                   else gather_replicated(getattr(self, n), d, self.group)
                   for n, d in self.dims.items()}
        self.lstm.train(self.training)
        return torch.func.functional_call(self.lstm, weights, (x,) if hx is None else (x, hx))


def shard_model_(model: nn.Module, mesh: Mesh, params: Mapping[str, tuple]) -> nn.Module:
    """Swap the layers of ``model`` whose parameters ``params`` (name ->
    placements, train_state_shardings' "params") shard over the model axis
    for their column-parallel counterparts, and give every BatchNorm the
    data axis's group (its statistics then span the global batch).
    Returns ``model``."""
    for name, mod in list(model.named_modules()):
        pre = f"{name}." if name else ""
        dims = {n: _model_dim(params[pre + n]) for n, _ in mod.named_parameters(recurse=False)}
        if not any(d is not None for d in dims.values()):
            new = None
        elif isinstance(mod, nn.Linear):
            new = ColumnParallelLinear(mod, mesh)
        elif isinstance(mod, nn.Conv1d):
            new = ColumnParallelConv1d(mod, mesh)
        elif isinstance(mod, nn.LSTM):
            new = ShardedLSTM(mod, mesh, dims)
        else:
            raise ValueError(f"{name}: no tensor-parallel form of {type(mod).__name__}")
        if new is not None:
            parent, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent), attr, new)
    if mesh.dp > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.data_group = mesh.data_group
    return model


class MeshAdam:
    """torch.optim.Adam over a mesh; see the module docstring.

    ``params``: (name, parameter) pairs, this rank's blocks; ``placements``:
    name -> (data, model) placements of the parameters, and ``zero``: name
    -> placements of their moments (train_state_shardings' "params" and
    "opt_state"); a name missing from either is replicated."""

    def __init__(self, params: Iterable[tuple[str, torch.Tensor]], mesh: Mesh, lr: float,
                 placements: Mapping[str, tuple] | None = None,
                 zero: Mapping[str, tuple] | None = None,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        self.mesh = mesh
        self.entries = []  # (name, param, model dim, data dim, what Adam updates)
        for name, p in params:
            mdim = _model_dim(placements[name]) if placements and name in placements else None
            ddim = _data_dim(zero[name]) if zero and name in zero and mesh.dp > 1 else None
            target = p if ddim is None else nn.Parameter(
                _block_of(p.detach(), ddim, mesh.dp, mesh.data_index).clone())
            self.entries.append((name, p, mdim, ddim, target))
        self.inner = torch.optim.Adam([e[4] for e in self.entries], lr=lr, betas=betas, eps=eps)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for _, p, _, _, t in self.entries:
            p.grad = t.grad = None

    @torch.no_grad()
    def step(self) -> None:
        mesh = self.mesh
        average_grads_([e[1] for e in self.entries if e[2] is not None], mesh.data_group)
        average_grads_([e[1] for e in self.entries if e[2] is None], mesh.group)
        for _, p, _, ddim, t in self.entries:
            if ddim is not None and p.grad is not None:
                t.grad = _block_of(p.grad, ddim, mesh.dp, mesh.data_index).contiguous()
        self.inner.step()
        for _, p, _, ddim, t in self.entries:
            if ddim is not None:
                p.copy_(gather_blocks(t.detach(), ddim, mesh.data_group))

    def shards(self, rank: int) -> Iterator[tuple[str, str, torch.Tensor, tuple[int, ...],
                                                   tuple[int, ...], bool]]:
        """What a checkpoint holds of each parameter, as this rank's blocks
        in torch's layout: (name, "param", "exp_avg" or "exp_avg_sq", the
        block, the whole tensor's shape, the block's index in the grid of
        equal blocks that tiles it, whether ``rank`` is the lowest rank
        holding the block, the one that writes it).  A parameter is split
        along its model dim, its moments also along their data dim (ZeRO);
        moments Adam has not made yet are zeros."""
        mesh = self.mesh
        replica0 = rank < mesh.dp * mesh.mp
        for name, p, mdim, ddim, t in self.entries:
            shape, index = list(p.shape), [0] * p.dim()
            if mdim is not None:
                shape[mdim] *= mesh.mp
                index[mdim] = mesh.model_index
            lowest = replica0 and (mdim is not None or mesh.model_index == 0)
            yield name, "param", p, tuple(shape), tuple(index), lowest and mesh.data_index == 0
            if ddim is not None:
                index[ddim] = index[ddim] * mesh.dp + mesh.data_index
            st = self.inner.state.get(t) or {}
            for key in ("exp_avg", "exp_avg_sq"):
                yield (name, key, st[key] if st else torch.zeros_like(t), tuple(shape),
                       tuple(index), lowest and (ddim is not None or mesh.data_index == 0))

    def step_count(self) -> int:
        """Adam's step count (0 before its first step)."""
        return next((int(st["step"]) for st in self.inner.state.values() if st), 0)

    def moment_bytes(self) -> dict[str, tuple[int, int]]:
        """name -> (bytes of Adam's moments this rank holds, bytes of the
        moments of this rank's whole parameter block)."""
        out = {}
        for name, p, _, _, t in self.entries:
            st = self.inner.state.get(t, {})
            moments = [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
            out[name] = (sum(m.numel() * m.element_size() for m in moments),
                         sum(p.numel() * m.element_size() for m in moments))
        return out


@torch.no_grad()
def gather_full_(full_model: nn.Module, full_opt: torch.optim.Adam,
                 model: nn.Module, opt: MeshAdam) -> None:
    """Fill ``full_model`` (the unsharded module, anywhere) and
    ``full_opt`` (a torch Adam over its parameters) with the weights,
    buffers and Adam state of the mesh's shards.  Collective: every rank
    of the mesh calls it."""
    mesh = opt.mesh
    bufs = dict(model.named_buffers())
    for n, b in full_model.named_buffers():
        b.copy_(bufs[n])
    full_params = dict(full_model.named_parameters())
    state = {}
    for i, (name, p, mdim, ddim, t) in enumerate(opt.entries):
        dst = full_params[name]
        dst.copy_(_whole(p, mdim, None, mesh))
        st = opt.inner.state.get(t)
        if st:
            state[i] = {"step": st["step"].clone(),
                        **{k: _whole(st[k], mdim, ddim, mesh).to(dst.device)
                           for k in ("exp_avg", "exp_avg_sq")}}
    full_opt.load_state_dict({"state": state,
                              "param_groups": full_opt.state_dict()["param_groups"]})


def _whole(t: torch.Tensor, mdim: int | None, ddim: int | None, mesh: Mesh) -> torch.Tensor:
    if ddim is not None:
        t = gather_blocks(t, ddim, mesh.data_group)
    if mdim is not None:
        t = gather_blocks(t, mdim, mesh.model_group)
    return t


@torch.no_grad()
def scatter_full_(model: nn.Module, opt: MeshAdam, full_model: nn.Module,
                  full_opt: torch.optim.Adam) -> None:
    """The inverse of gather_full_: every rank takes its blocks of the
    whole weights, buffers and Adam state.  Local: no collective."""
    mesh = opt.mesh
    bufs = dict(full_model.named_buffers())
    for n, b in model.named_buffers():
        b.copy_(bufs[n])
    full_params = dict(full_model.named_parameters())
    full_state = full_opt.state_dict()["state"]
    state = {}
    for i, (name, p, mdim, ddim, t) in enumerate(opt.entries):
        block = _block_of(full_params[name], mdim, mesh.mp, mesh.model_index)
        p.copy_(block)
        if ddim is not None:
            t.copy_(_block_of(block, ddim, mesh.dp, mesh.data_index))
        st = full_state.get(i)
        if st:
            state[i] = {"step": st["step"].clone(), **{
                k: _block_of(_block_of(st[k], mdim, mesh.mp, mesh.model_index),
                             ddim, mesh.dp, mesh.data_index).to(p.device).clone()
                for k in ("exp_avg", "exp_avg_sq")}}
    opt.inner.load_state_dict({"state": state,
                               "param_groups": opt.inner.state_dict()["param_groups"]})
