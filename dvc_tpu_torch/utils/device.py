"""Device rules shared by every entry point.

Entry points take an explicit ``device=`` and default to ``"cuda"``.  Asking
for cuda without a card raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names cuda and no card is
    visible.  A bare "cuda" becomes this thread's current card, by index:
    under torchrun that is the rank's card, and a worker thread (whose
    current card is card 0) then uses the same one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=128)
def device_constant(make: Callable[..., np.ndarray], args: tuple, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``make(*args)``, a host constant (a window, a filterbank's inverse),
    as a tensor on ``device``, copied there once per (make, args, device,
    dtype): a copy from pageable host memory waits for the stream, so one in
    every step keeps the host from queueing ahead.  Made outside inference
    mode, so that a constant first made while serving can be saved for a
    train step's backward.  Callers must not write to it."""
    with torch.inference_mode(False):
        return torch.from_numpy(np.asarray(make(*args))).to(device, dtype)


def use_exact_float32() -> None:
    """Serve the VAE in full float32: cuDNN convolutions default to TF32
    (about three decimal digits) and would break parity with the reference,
    so turn TF32 off for both cuDNN and cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
