"""Checkpoint discovery and loading, load side (port of
dvc_tpu/train/checkpoint.py:63-84).

Reference model/variational_base_vae.py:127-149,199-201: checkpoints are
``{run_name}_{epoch}`` files in a flat directory; resume globs the
directory, parses the epoch out of each name and loads the largest.  The
port reads the reference's own format, ``DisentangledVAE_VCTK_{epoch}.pth``
torch state dicts.  Saving waits for the training slice.
"""

from __future__ import annotations

import os
from glob import glob

import torch

from dvc_tpu_torch.utils.convert import load_torch_state_dict

SUFFIX = ".pth"
RUN_NAME = "DisentangledVAE_VCTK"


def _epoch_of(path: str) -> int | None:
    stem = os.path.basename(path)
    if stem.endswith(SUFFIX):
        stem = stem[: -len(SUFFIX)]
    epoch_str = stem.rsplit("_", 1)[-1]
    return int(epoch_str) if epoch_str.isdigit() else None


def latest_checkpoint_step(checkpoints_path: str) -> tuple[int, str] | None:
    """(max_epoch, path) over ``DisentangledVAE_VCTK_<epoch>.pth``, or None."""
    candidates = []
    for f in glob(os.path.join(checkpoints_path, f"{RUN_NAME}_*{SUFFIX}")):
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
