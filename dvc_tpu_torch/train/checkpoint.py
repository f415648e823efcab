"""Checkpoint save, discovery and loading (port of dvc_tpu/train/checkpoint.py).

Reference model/variational_base_vae.py:127-149,199-201: checkpoints are
``{run_name}_{epoch}`` files in a flat directory; resume globs the
directory, parses the epoch out of each name and loads the largest.

Two formats are written and read:

  * ``{run_name}_{epoch}.msgpack``: dvc_tpu's format, the whole TrainState
    (``step``, ``params``, ``batch_stats``, ``opt_state``) as
    ``flax.serialization.to_bytes`` writes it (dvc_tpu/train/checkpoint.py:
    37-45), written with the port's own msgpack writer.  dvc_tpu's
    ``load_last_checkpoint`` restores it, and the port reads dvc_tpu's.
  * ``{run_name}_{epoch}.pth``: the reference's own format, a plain state
    dict with the reference names, which the reference reads as it is.
    Beside it, ``{run_name}_{epoch}.opt.pth`` holds the Adam state and the
    step (the reference drops them, SURVEY.md §5); discovery skips that
    file, whose stem does not end in an epoch number.  The pair also keeps
    what dvc_tpu's tree has no place for (BatchNorm's num_batches_tracked).

  * ``{run_name}_{epoch}.orbax/``: dvc_tpu's sharded format
    (dvc_tpu/train/checkpoint.py:48-60), the same TrainState as an orbax
    checkpoint (``utils/orbax.py``: zarr arrays in an OCDBT store, read
    and written from the bytes).  dvc_tpu's ``load_last_checkpoint``
    restores it, with or without shardings, and the port reads dvc_tpu's.
    Under a mesh every rank writes the chunks it holds into its own
    ``ocdbt.process_<rank>/`` and rank 0 writes the metadata and the root
    B-tree (``save_orbax_sharded``): no rank gathers the state.

A save writes the .msgpack (or the .orbax directory, into a temporary
name first), then the .opt.pth, then the .pth, each whole before the next,
so every file that discovery can find is complete.  Discovery takes the
newest epoch across the formats, as dvc_tpu does across its two; on a tie,
the file written last (the .pth of a one-process port run).  A mesh's
sharded .orbax save writes no .pth pair, which would take the gather it
avoids: it stands alone as dvc_tpu's does.
"""

from __future__ import annotations

import os
import shutil
from glob import glob
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import (flax_array, flax_shape, load_torch_state_dict,
                                         optax_adam_from_torch, torch_adam_from_optax,
                                         vae_state_dict_from_jax, vae_tree_from_state_dict,
                                         vae_tree_paths)
from dvc_tpu_torch.utils.orbax import (finish_orbax_state, leaves_of, read_orbax_state,
                                       write_orbax_shards, write_orbax_state)

SUFFIX = ".pth"
OPT_SUFFIX = ".opt.pth"
MSGPACK_SUFFIX = ".msgpack"
ORBAX_SUFFIX = ".orbax"
RUN_NAME = "DisentangledVAE_VCTK"
TRAIN_STATE_KEYS = {"step", "params", "batch_stats", "opt_state"}
# the order in which save writes the formats: on an epoch tie, the later wins
_SUFFIXES = (ORBAX_SUFFIX, MSGPACK_SUFFIX, SUFFIX)


def _epoch_of(path: str) -> int | None:
    stem = os.path.basename(path)
    for sfx in _SUFFIXES:
        if stem.endswith(sfx):
            stem = stem[: -len(sfx)]
            break
    epoch_str = stem.rsplit("_", 1)[-1]
    return int(epoch_str) if epoch_str.isdigit() else None


def _sorted_tree(tree: Any) -> Any:
    """Dicts with their keys sorted at every level, the order of a trained
    dvc_tpu state's dicts (jax's pytree flattening sorts dict keys)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _vae_params(sd: dict) -> dict:
    return vae_tree_from_state_dict(sd)[0]


def train_state_tree(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer | None, step: int) -> dict:
    """The VAE and its Adam as dvc_tpu's TrainState state dict: numpy
    leaves, int32 scalars for the step and Adam's count, the TrainState's
    fields in their order and every dict below them sorted, so the bytes
    are those dvc_tpu's Trainer.save writes for the same trained state."""
    params, stats = vae_tree_from_state_dict(model.state_dict())
    if optimizer is None:
        zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        opt_state = {"0": {"count": np.array(0, np.int32), "mu": _vae_params(zeros),
                           "nu": _vae_params(zeros)}, "1": {}}
    else:
        opt_state = optax_adam_from_torch(model, optimizer, _vae_params)
    return {"step": np.array(step, np.int32), "params": _sorted_tree(params),
            "batch_stats": _sorted_tree(stats), "opt_state": _sorted_tree(opt_state)}


def _replace_dir(tmp: str, final: str) -> None:
    """Move the finished directory ``tmp`` to ``final``, replacing one
    there (dvc_tpu's orbax save overwrites, ``force=True``)."""
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save_checkpoint(checkpoints_path: str, run_name: str, epoch: int,
                    model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    step: int = 0, fmt: str = "msgpack") -> str:
    """Write ``{run_name}_{epoch}.msgpack`` (``fmt="msgpack"``) or the
    ``.orbax`` directory (``fmt="orbax"``), the whole TrainState in
    dvc_tpu's format, then, with an optimizer, ``.opt.pth``, then ``.pth``
    (the model's state dict, on the CPU); returns the .pth's path.  The
    optimizer file comes before the model file, so a .pth that discovery
    can find always has its optimizer state beside it."""
    if fmt not in ("msgpack", "orbax"):
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    os.makedirs(checkpoints_path, exist_ok=True)
    base = os.path.join(checkpoints_path, f"{run_name}_{epoch}")
    tree = train_state_tree(model, optimizer, step)
    if fmt == "orbax":
        tmp = f"{base}{ORBAX_SUFFIX}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        write_orbax_state(tmp, tree)
        _replace_dir(tmp, base + ORBAX_SUFFIX)
    else:
        tmp = f"{base}{MSGPACK_SUFFIX}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(tree))
        os.replace(tmp, base + MSGPACK_SUFFIX)
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(), "step": int(step)},
                   base + OPT_SUFFIX)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               base + SUFFIX)
    return base + SUFFIX


def _rank_chunks(model: torch.nn.Module, opt: Any, step: int, rank: int
                 ) -> tuple[list, dict]:
    """The TrainState's leaves (global shapes, chunk grids) and the chunks
    of them this rank writes: ``opt`` is the mesh's ``MeshAdam``, whose
    ``shards`` give each parameter's and moment's block and whether this
    rank writes it; rank 0 writes the replicated statistics and counts."""
    paths = vae_tree_paths(dict(model.state_dict()))
    spec: dict = {"step": np.array(0, np.int32), "params": {}, "batch_stats": {},
                  "opt_state": {"0": {"count": np.array(0, np.int32), "mu": {}, "nu": {}},
                                "1": {}}}
    chunks: dict = {}
    held: dict = {}

    def put(root: tuple, name: str, block: torch.Tensor, shape: tuple, index: tuple,
            writes: bool):
        kind, path = paths[name]
        full = (root or (kind,)) + path
        node = spec
        for k in full[:-1]:
            node = node.setdefault(k, {})
        node[full[-1]] = np.broadcast_to(np.float32(0), flax_shape(name, shape))
        chunks[full] = flax_shape(name, tuple(block.shape))
        if writes:
            held.setdefault(full, {})[flax_shape(name, index)] = flax_array(name, block)

    for name, b in model.named_buffers():
        if paths.get(name, ("",))[0] == "batch_stats":
            put((), name, b, tuple(b.shape), (0,) * b.dim(), rank == 0)
    roots = {"param": (), "exp_avg": ("opt_state", "0", "mu"),
             "exp_avg_sq": ("opt_state", "0", "nu")}
    for name, what, block, shape, index, writes in opt.shards(rank):
        put(roots[what], name, block, shape, index, writes)
    if rank == 0:
        held[("step",)] = {(): np.array(step, np.int32)}
        held[("opt_state", "0", "count")] = {(): np.array(opt.step_count(), np.int32)}
    return leaves_of(_sorted_tree(spec), chunks), held


def save_orbax_sharded(checkpoints_path: str, run_name: str, epoch: int,
                       model: torch.nn.Module, opt: Any, step: int) -> str:
    """The mesh's orbax save, collective over the process group: every
    rank writes the chunks it holds (``_rank_chunks``) into its own
    ``ocdbt.process_<rank>/``; after a barrier rank 0 writes the JSON files
    and the root B-tree over all of them, and moves the directory into
    place; a last barrier, and every rank returns the path."""
    rank, world = dist.get_rank(), dist.get_world_size()
    final = os.path.join(checkpoints_path, f"{run_name}_{epoch}{ORBAX_SUFFIX}")
    tmp = final + ".tmp"
    if rank == 0:
        os.makedirs(checkpoints_path, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    dist.barrier()
    leaves, held = _rank_chunks(model, opt, step, rank)
    write_orbax_shards(tmp, rank, leaves, held)
    dist.barrier()
    if rank == 0:
        finish_orbax_state(tmp, leaves, list(range(world)))
        _replace_dir(tmp, final)
    dist.barrier()
    return final


def latest_checkpoint_step(checkpoints_path: str,
                           run_name: str = RUN_NAME) -> tuple[int, str] | None:
    """(max_epoch, path) over ``{run_name}_<epoch>`` .pth, .msgpack and
    .orbax checkpoints, or None; on an epoch tie, the newest file (then
    the format save writes last)."""
    candidates = []
    for sfx in _SUFFIXES:
        for f in glob(os.path.join(checkpoints_path, f"{run_name}_*{sfx}")):
            epoch = _epoch_of(f)
            if epoch is not None:
                candidates.append((epoch, os.stat(f).st_mtime_ns, _SUFFIXES.index(sfx), f))
    if not candidates:
        return None
    best = max(candidates)
    return best[0], best[3]


def read_train_state(path: str) -> dict:
    """A dvc_tpu TrainState, .msgpack or .orbax, as a tree of numpy arrays."""
    if path.rstrip(os.sep).endswith(ORBAX_SUFFIX):
        tree = read_orbax_state(path)
    else:
        with open(path, "rb") as f:
            tree = msgpack.unpackb(f.read())
    missing = TRAIN_STATE_KEYS - set(tree)
    if missing:
        raise ValueError(f"{path}: not a TrainState checkpoint (no {sorted(missing)})")
    return tree


def _load_model_file(path: str, model: torch.nn.Module) -> dict | None:
    """Load a .pth, .msgpack or .orbax into ``model``; returns the
    TrainState tree of a .msgpack or .orbax (None for a .pth)."""
    if path.endswith((MSGPACK_SUFFIX, ORBAX_SUFFIX)):
        tree = read_train_state(path)
        model.load_state_dict(vae_state_dict_from_jax(tree["params"], tree["batch_stats"]))
        return tree
    model.load_state_dict(load_torch_state_dict(path))
    return None


def load_last_checkpoint(checkpoints_path: str, model: torch.nn.Module,
                         run_name: str = RUN_NAME) -> int:
    """Load the highest-epoch checkpoint, of either format, into ``model``;
    returns its epoch.  Raises FileNotFoundError when there is none."""
    found = latest_checkpoint_step(checkpoints_path, run_name)
    if found is None:
        raise FileNotFoundError(
            f"no {run_name}_<epoch>{SUFFIX}, {MSGPACK_SUFFIX} or {ORBAX_SUFFIX} checkpoint under "
            f"{checkpoints_path}")
    epoch, path = found
    _load_model_file(path, model)
    return epoch


def load_train_state(checkpoints_path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     run_name: str = RUN_NAME) -> tuple[int, int] | None:
    """Resume: load the newest checkpoint into ``model`` and its Adam state
    into ``optimizer`` (from the .opt.pth beside a .pth, or from a
    .msgpack's or .orbax's optax state); returns (epoch, step), or None when there is
    no checkpoint.  A .pth without an optimizer file (a reference
    checkpoint) restarts Adam at step 0."""
    found = latest_checkpoint_step(checkpoints_path, run_name)
    if found is None:
        return None
    epoch, path = found
    tree = _load_model_file(path, model)
    if tree is not None:
        torch_adam_from_optax(model, optimizer, tree["opt_state"],
                              lambda t: vae_state_dict_from_jax(t, None))
        return epoch, int(np.asarray(tree["step"]))
    opt_path = path[: -len(SUFFIX)] + OPT_SUFFIX
    if not os.path.exists(opt_path):
        return epoch, 0
    blob = torch.load(opt_path, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(blob["optimizer"])
    return epoch, int(blob["step"])
