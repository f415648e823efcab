"""Pitch helpers (port of dvc_tpu/ops/pitch.py; reference
preprocessing/utils.py:146-204).

The reference wraps pyworld.dio: ``estimate_pitch`` (utils.py:183-192) is
the F0 shifted by its min, divided by its max and scaled to
ceil(x * 256) bins; ``get_batch_pitch`` (utils.py:194-204) loops over a
batch.  As in dvc_tpu the tracker is the device NCCF tracker
(ops/world.estimate_f0, the same floor/ceil contract) and the batch is one
call over its rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dvc_tpu_torch.ops.world import estimate_f0


def estimate_pitch(segment: torch.Tensor, sr: int = 16_000,
                   fmin: float = 50.0, fmax: float = 2000.0) -> torch.Tensor:
    """Quantized pitch contour (reference utils.py:183-192): (f0 - min) /
    max, the reference's formula (not (f0 - min) / (max - min): a fully
    voiced segment stays below 1, a quirk kept), scaled to ceil(x * 256)."""
    f0, _ = estimate_f0(torch.as_tensor(segment, dtype=torch.float32), sr,
                        f0_floor=fmin, f0_ceil=fmax)
    return torch.ceil((f0 - f0.min()) / f0.max().clamp(min=1e-6) * 256.0)


def get_batch_pitch(batch: torch.Tensor, sr: int = 16_000) -> torch.Tensor:
    """(B, T) waveforms -> (B, n_frames) quantized pitch (the reference's
    per-item loop, utils.py:194-204)."""
    return torch.stack([estimate_pitch(w, sr) for w in torch.as_tensor(batch)])


def quantized_pitch_onehot(pitch: torch.Tensor, bins: int = 257) -> torch.Tensor:
    """One-hot pitch conditioning (the 257-dim f0 feature of the
    F0-conditioned AutoVC decoder, autovc_replicate/original_autovc.py:228),
    float32."""
    idx = torch.as_tensor(pitch).to(torch.int64).clamp(0, bins - 1)
    return F.one_hot(idx, bins).to(torch.float32)
