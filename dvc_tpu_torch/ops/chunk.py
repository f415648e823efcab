"""Fixed-length chunking of arbitrary-length mels (port of dvc_tpu/ops/chunk.py).

Reference semantics (model/variational_base_vae.py:335-348): split (80, T)
into 64-frame blocks, zero-padding the last; the reference always emits
``T//64 + 1`` chunks, so when T is an exact multiple of 64 the final chunk
is all zeros — kept, because style averaging over chunks depends on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def num_chunks(t: int, frames: int = 64) -> int:
    """The reference chunk count for a T-frame mel: T//frames + 1."""
    return t // frames + 1


def chunk_mel(mel: torch.Tensor, frames: int = 64) -> torch.Tensor:
    """(n_mels, T) -> (num_chunks(T), n_mels, frames)."""
    n_mels, t = mel.shape
    n = num_chunks(t, frames)
    padded = F.pad(mel, (0, n * frames - t))
    return padded.reshape(n_mels, n, frames).permute(1, 0, 2)


def unchunk_mel(chunks: torch.Tensor, total_frames: int | None = None) -> torch.Tensor:
    """(num_chunks, n_mels, frames) -> (n_mels, num_chunks*frames), optionally
    cropped (the reference keeps the padded tail: total_frames=None)."""
    c, n_mels, f = chunks.shape
    out = chunks.permute(1, 0, 2).reshape(n_mels, c * f)
    if total_frames is not None:
        out = out[:, :total_frames]
    return out
