"""Device rules shared by every entry point.

Entry points take an explicit ``device=`` and default to ``"cuda"``.  Asking
for cuda without a card raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names cuda and no card is
    visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def use_exact_float32() -> None:
    """Serve the VAE in full float32: cuDNN convolutions default to TF32
    (about three decimal digits) and would break parity with the reference,
    so turn TF32 off for both cuDNN and cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
