"""Device mesh and sharding rules (port of dvc_tpu/parallel/mesh.py), on
torch.distributed.

dvc_tpu names two mesh axes and lets GSPMD insert the collectives:

  data  — the batch axis: gradients are averaged over it, and with
          ``MeshConfig.shard_opt_state`` Adam's moments are sharded over it
          (ZeRO, ``zero_sharding_for``);
  model — tensor parallelism: the large matmul weights keep a slice of
          their output features on each device (``param_sharding_for``).

Here a device is a process (one rank a card, as torchrun starts them), and
the mesh is laid out as dvc_tpu lays out its device list: the rank at data
index d and model index m of replica k is ``k * dp * mp + d * mp + m``.
dvc_tpu leaves the devices beyond ``dp * mp`` idle; a process cannot idle
through a training loop, so a world of several ``dp * mp`` meshes runs them
as replicas, each computing the same step, and any other world is refused.
``Mesh`` holds this rank's process groups: the data axis, the model axis
and the whole ``dp x mp`` mesh.  A mesh of one rank without a process
group has no groups at all.

Placements are DTensor's names, one per mesh axis (data, model):
``Shard(dim)`` or ``Replicate()``.  The rules are pure functions of
parameter names, torch shapes and mesh sizes.  dvc_tpu states them on its
flax layout, where a Dense kernel is (in, out), a conv kernel (k, in, out)
and an LSTM weight (4H, in) as in torch; the torch layout reverses the
first two, so dvc_tpu's axis a of an n-D Linear or Conv1d weight is torch's
dim n - 1 - a, and an LSTM weight's axes are the same in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dvc_tpu_torch.config import MeshConfig
from dvc_tpu_torch.utils.convert import flax_shape, keeps_torch_layout
from dvc_tpu_torch.utils.device import resolve_device

ZERO_MIN_SIZE = 2 ** 14   # dvc_tpu's _zero_spec: smaller tensors stay replicated
TP_MIN_SIZE = 2 ** 12     # dvc_tpu's _model_spec
# dvc_tpu's _TP_EXCLUDE: pre_linear2's output features are reshaped into
# (time, features) and scanned, so dvc_tpu replicates it (mesh.py:94-101)
TP_EXCLUDE = ("pre_linear2",)


@dataclass(frozen=True)
class Shard:
    """The tensor is split evenly along ``dim`` over a mesh axis."""

    dim: int


@dataclass(frozen=True)
class Replicate:
    """Every rank of a mesh axis holds the whole tensor."""


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh and its process groups.

    ``data_group`` / ``model_group`` hold the ranks that share this rank's
    model / data index; ``group`` the whole dp x mp mesh.  A group is None
    only where there is no process group (a one-rank mesh)."""

    axis_names: tuple[str, str]
    dp: int
    mp: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    group: Any
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.dp, self.axis_names[1]: self.mp}


def mesh_shape(cfg: MeshConfig, n: int) -> tuple[int, int]:
    """(dp, mp) of a mesh over n devices, dvc_tpu's rule: mp =
    max(1, model_parallel), dp = data_parallel if positive, else n // mp."""
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp < 1 or dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs more than {n} devices")
    return dp, mp


def has_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if has_process_group() else 1


def _new_group(ranks: list[int], world: int):
    # the default group already spans the world: no second communicator
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def make_mesh(cfg: MeshConfig = MeshConfig(), device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every rank of the process group (one rank when there
    is none), its shape by ``mesh_shape``; ``device`` is where this rank
    computes.  Every rank must call it, in the same order as any other
    ``make_mesh``: it creates process groups."""
    dev = resolve_device(device)
    world = world_size()
    dp, mp = mesh_shape(cfg, world)
    names = (cfg.data_axis, cfg.model_axis)
    if not has_process_group():
        return Mesh(names, dp, mp, 0, 0, None, None, None, dev)
    size = dp * mp
    if world % size:
        raise ValueError(f"a world of {world} ranks is not a whole number of {dp}x{mp} "
                         f"meshes; start a multiple of {size} processes")
    rank = dist.get_rank()
    mine = {}
    # every rank creates every group, in one order (new_group is collective)
    for base in range(0, world, size):
        for d in range(dp):
            ranks = [base + d * mp + m for m in range(mp)]
            g = _new_group(ranks, world)
            if rank in ranks:
                mine["model"] = g
        for m in range(mp):
            ranks = [base + d * mp + m for d in range(dp)]
            g = _new_group(ranks, world)
            if rank in ranks:
                mine["data"] = g
        ranks = list(range(base, base + size))
        g = _new_group(ranks, world)
        if rank in ranks:
            mine["mesh"] = g
    pos = rank % size
    return Mesh(names, dp, mp, pos // mp, pos % mp, mine["data"], mine["model"],
                mine["mesh"], dev)


def data_sharding(mesh: Mesh) -> tuple:
    """The leading (batch) axis over the data axis, the rest replicated."""
    return (Shard(0), Replicate())


def replicated(mesh: Mesh) -> tuple:
    return (Replicate(), Replicate())


def _flax_axis_to_torch(name: str, ndim: int, axis: int) -> int:
    return axis if keeps_torch_layout(name) or ndim == 1 else ndim - 1 - axis


def zero_placement(name: str, shape: Sequence[int], dp: int) -> Shard | Replicate:
    """dvc_tpu's _zero_spec on one tensor: tensors of at least ZERO_MIN_SIZE
    elements shard their largest axis (in dvc_tpu's order, argsort of its
    layout's shape, last first) that dp divides; the rest replicate."""
    fshape = flax_shape(name, shape)
    if len(fshape) == 0 or int(np.prod(fshape)) < ZERO_MIN_SIZE:
        return Replicate()
    for ax in np.argsort(fshape)[::-1]:
        if fshape[ax] % dp == 0:
            return Shard(_flax_axis_to_torch(name, len(fshape), int(ax)))
    return Replicate()


def model_placement(name: str, shape: Sequence[int], mp: int) -> Shard | Replicate:
    """dvc_tpu's column-parallel _model_spec on one parameter: a weight of
    2 or more dims and at least TP_MIN_SIZE elements whose last dvc_tpu
    axis mp divides shards that axis (a Linear's or Conv1d's output
    features, torch dim 0; an LSTM weight's input features, torch dim 1),
    unless its name holds one of TP_EXCLUDE; the rest replicate."""
    fshape = flax_shape(name, shape)
    if (mp <= 1 or len(fshape) < 2 or int(np.prod(fshape)) < TP_MIN_SIZE
            or fshape[-1] % mp or any(ex in name for ex in TP_EXCLUDE)):
        return Replicate()
    return Shard(_flax_axis_to_torch(name, len(fshape), len(fshape) - 1))


def zero_sharding_for(shapes: Mapping[str, Sequence[int]],
                      mesh_shape: Mapping[str, int]) -> dict[str, tuple]:
    """name -> (data, model) placements of Adam's moments by ZeRO: the
    data-axis rule of zero_placement, replicated over the model axis."""
    dp = list(mesh_shape.values())[0]
    return {n: (zero_placement(n, s, dp), Replicate()) for n, s in shapes.items()}


def param_sharding_for(shapes: Mapping[str, Sequence[int]],
                       mesh_shape: Mapping[str, int]) -> dict[str, tuple]:
    """name -> (data, model) placements of the parameters: model-axis
    tensor parallelism by model_placement, replicated over the data axis."""
    mp = list(mesh_shape.values())[1]
    return {n: (Replicate(), model_placement(n, s, mp)) for n, s in shapes.items()}


def local_shape(shape: Sequence[int], placement: tuple, mesh_shape: Mapping[str, int]
                ) -> tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` placed by
    ``placement`` (one entry per mesh axis)."""
    out = list(shape)
    for p, n in zip(placement, mesh_shape.values()):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


def train_state_shardings(model: torch.nn.Module, mesh_shape: Mapping[str, int],
                          shard_opt_state: bool = True) -> dict[str, dict[str, tuple]]:
    """Placements of a train state (dvc_tpu's train_state_shardings):
    "params" tensor-parallel over the model axis, "opt_state" (Adam's
    moments, by parameter name) ZeRO-sharded over the data axis when
    ``shard_opt_state``, else replicated; "batch_stats" replicated.

    ZeRO is applied to each rank's tensor-parallel block of a parameter:
    dvc_tpu keeps the moments of a model-sharded weight whole along the
    model axis, the port keeps each rank's block's moments, so with
    model_parallel > 1 a rank holds 1/(dp * mp) of such a moment where
    dvc_tpu's device holds 1/dp."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = param_sharding_for(shapes, mesh_shape)
    rep = (Replicate(), Replicate())
    if shard_opt_state:
        local = {n: local_shape(s, params[n], mesh_shape) for n, s in shapes.items()}
        opt = zero_sharding_for(local, mesh_shape)
    else:
        opt = {n: rep for n in shapes}
    return {"params": params, "opt_state": opt,
            "batch_stats": {n: rep for n, _ in model.named_buffers()}}


def data_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of n rows sharded on the data axis."""
    if n % mesh.dp:
        raise ValueError(f"batch {n} does not split over the {mesh.dp}-way data axis")
    k = n // mesh.dp
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """A host batch (numpy arrays, or a tuple of them, each of the global
    batch's rows) -> this rank's rows as tensors on the mesh's device
    (float arrays as float32)."""
    def put(a):
        a = np.asarray(a)
        a = a[data_rows(len(a), mesh)]
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device, non_blocking=True)

    if isinstance(batch, (tuple, list)):
        return type(batch)(put(a) for a in batch)
    return put(batch)
