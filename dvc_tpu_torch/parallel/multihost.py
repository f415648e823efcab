"""Multi-process execution (port of dvc_tpu/parallel/multihost.py), on
torch.distributed.

dvc_tpu initializes ``jax.distributed`` and drives every local device from
one process; the port runs one process a card, as torchrun starts them:
``initialize_distributed`` joins the process group from its arguments or
from torchrun's environment and pins the rank to its card,
``global_mesh`` lays the mesh over every rank, ``PerHostBatcher`` gives
each rank its rows of a batch that every rank reads alike, and
``is_primary`` names the rank that writes files.

One process without torchrun's environment is the degenerate case: no
process group, every helper a passthrough, so the same script runs from
one card to many.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from dvc_tpu_torch.config import MeshConfig
from dvc_tpu_torch.parallel.mesh import (Mesh, has_process_group, make_mesh, shard_batch,
                                         world_size)
from dvc_tpu_torch.utils.device import resolve_device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str | torch.device = "cuda",
                           timeout: datetime.timedelta | None = None) -> bool:
    """Join the process group: NCCL on cuda (this rank's card is
    ``cuda:LOCAL_RANK``), gloo on the CPU.  The address ("host:port", or
    a URL such as ``file:///path``), world size and rank come from the
    arguments or from torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
    RANK and LOCAL_RANK.  With none of them this does nothing.  Returns
    whether the world has more than one process."""
    if has_process_group():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=coordinator_address or "env://",
                            world_size=world, rank=rank, **kw)
    return world > 1


def global_mesh(cfg: MeshConfig = MeshConfig(), device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every rank of every host."""
    return make_mesh(cfg, device)


@dataclass
class PerHostBatcher:
    """Each rank reads the same host batch and keeps its rows of it."""

    mesh: Mesh

    def global_batch(self, batch: Any) -> Any:
        """This rank's rows of ``batch`` (numpy, or a tuple of arrays) on
        its device (mesh.shard_batch)."""
        return shard_batch(batch, self.mesh)

    def local_batch_size(self, global_batch_size: int) -> int:
        n = world_size()
        if global_batch_size % n:
            raise ValueError(f"global batch {global_batch_size} must divide {n} processes")
        return global_batch_size // n


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and figures: rank
    0, or the only process."""
    return not has_process_group() or dist.get_rank() == 0
