"""Checkpoint save, discovery and loading (port of dvc_tpu/train/checkpoint.py).

Reference model/variational_base_vae.py:127-149,199-201: checkpoints are
``{run_name}_{epoch}`` files in a flat directory; resume globs the
directory, parses the epoch out of each name and loads the largest.  The
model file is the reference's own format, ``DisentangledVAE_VCTK_{epoch}.pth``:
a plain state dict with the reference names, which ``serve``, ``convert``
and the reference read as it is.  Beside it, ``{run_name}_{epoch}.opt.pth``
holds the Adam state and the step, so that a resume restores the optimizer
as dvc_tpu's full TrainState does (the reference drops it, SURVEY.md §5);
discovery skips that file, whose stem does not end in an epoch number.
"""

from __future__ import annotations

import os
from glob import glob

import torch

from dvc_tpu_torch.utils.convert import load_torch_state_dict

SUFFIX = ".pth"
OPT_SUFFIX = ".opt.pth"
RUN_NAME = "DisentangledVAE_VCTK"


def _epoch_of(path: str) -> int | None:
    stem = os.path.basename(path)
    if stem.endswith(SUFFIX):
        stem = stem[: -len(SUFFIX)]
    epoch_str = stem.rsplit("_", 1)[-1]
    return int(epoch_str) if epoch_str.isdigit() else None


def save_checkpoint(checkpoints_path: str, run_name: str, epoch: int,
                    model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    step: int = 0) -> str:
    """Write ``{run_name}_{epoch}.pth`` (the model's state dict, on the CPU)
    and, with an optimizer, ``{run_name}_{epoch}.opt.pth``; returns the
    model file's path.  The optimizer file is written first, so a model
    file that discovery can find always has its optimizer state beside it."""
    os.makedirs(checkpoints_path, exist_ok=True)
    base = os.path.join(checkpoints_path, f"{run_name}_{epoch}")
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(), "step": int(step)},
                   base + OPT_SUFFIX)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               base + SUFFIX)
    return base + SUFFIX


def latest_checkpoint_step(checkpoints_path: str,
                           run_name: str = RUN_NAME) -> tuple[int, str] | None:
    """(max_epoch, path) over ``{run_name}_<epoch>.pth``, or None."""
    candidates = []
    for f in glob(os.path.join(checkpoints_path, f"{run_name}_*{SUFFIX}")):
        epoch = _epoch_of(f)
        if epoch is not None:
            candidates.append((epoch, f))
    if not candidates:
        return None
    return max(candidates, key=lambda item: item[0])


def load_last_checkpoint(checkpoints_path: str, model: torch.nn.Module) -> int:
    """Load the highest-epoch checkpoint into ``model``; returns its epoch.
    Raises FileNotFoundError when there is none."""
    found = latest_checkpoint_step(checkpoints_path)
    if found is None:
        raise FileNotFoundError(
            f"no {RUN_NAME}_<epoch>{SUFFIX} checkpoint under {checkpoints_path}")
    epoch, path = found
    model.load_state_dict(load_torch_state_dict(path))
    return epoch


def load_train_state(checkpoints_path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     run_name: str = RUN_NAME) -> tuple[int, int] | None:
    """Resume: load the newest ``{run_name}_<epoch>.pth`` into ``model`` and
    its ``.opt.pth`` into ``optimizer``; returns (epoch, step), or None when
    there is no checkpoint.  A model file without an optimizer file (a
    reference checkpoint) restarts Adam at step 0."""
    found = latest_checkpoint_step(checkpoints_path, run_name)
    if found is None:
        return None
    epoch, path = found
    model.load_state_dict(load_torch_state_dict(path))
    opt_path = path[: -len(SUFFIX)] + OPT_SUFFIX
    if not os.path.exists(opt_path):
        return epoch, 0
    blob = torch.load(opt_path, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(blob["optimizer"])
    return epoch, int(blob["step"])
