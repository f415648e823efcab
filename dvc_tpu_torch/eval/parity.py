"""Reference-checkpoint parity harness (port of dvc_tpu/eval/parity.py).

BASELINE.md gates output fidelity on the published reference checkpoints
(reference README.md:13-14): the mel-reconstruction error and the
converted-utterance MCD.  This is the measurement: load a reference
``DisentangledVAE_VCTK_*.pth`` into the port's VAE (it keeps the
reference's state-dict names, so the file loads as it is), reconstruct
64-frame crops of a mel set in eval mode, and report the error
statistics.  The published files are not in this repository; the tests
use tools/gen_parity_ckpt.py's full-size fixtures, which have the same
names and layouts.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from dvc_tpu_torch.config import Config, VAEConfig
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.utils.convert import load_torch_state_dict
from dvc_tpu_torch.utils.device import resolve_device


def load_reference_checkpoint(pth_path: str, cfg: VAEConfig = VAEConfig(),
                              device: str | torch.device = "cuda") -> DisentangledVAE:
    """A reference .pth state dict -> the port's VAE on ``device``, in
    eval mode."""
    model = DisentangledVAE(cfg)
    model.load_state_dict(load_torch_state_dict(pth_path))
    return model.to(resolve_device(device)).eval()


def mel_reconstruction_error(model: DisentangledVAE, mels: list[np.ndarray],
                             frames: int = 64) -> dict[str, float]:
    """Eval-mode reconstruction error over the ``frames``-frame crops of
    ``mels`` ((80, T) arrays; a shorter one is zero-padded to a crop):
    decode(style_mu, content_mu) against the crop, per frame."""
    crops = []
    for mel in mels:
        t = mel.shape[1]
        if t < frames:
            mel = np.pad(mel, ((0, 0), (0, frames - t)))
            t = frames
        for s in range(0, t - frames + 1, frames):
            crops.append(mel[:, s:s + frames])
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.stack(crops).astype(np.float32)).to(dev)
    with torch.no_grad():
        smu, _, cmu, _ = model.encode(x)
        recons = model.decode(torch.cat([smu, cmu], dim=-1))
    diff = (recons - x).abs().cpu().numpy()
    return {"n_crops": len(crops), "l1_per_frame": float(diff.mean()),
            "l2_per_frame": float(np.sqrt((diff ** 2).mean())),
            "max_abs": float(diff.max())}


def parity_report(pth_path: str, mel_dir: str, cfg: Config = Config(),
                  max_utterances: int = 32, device: str | torch.device = "cuda") -> dict:
    """The parity numbers of a reference checkpoint on a mel directory
    (speaker subdirectories of .npy files, the preprocessing layout)."""
    model = load_reference_checkpoint(pth_path, cfg.vae, device)
    fps = sorted(glob.glob(os.path.join(mel_dir, "*", "*.npy")))[:max_utterances]
    mels = [np.load(fp) for fp in fps]
    report = mel_reconstruction_error(model, mels, cfg.vae.frames)
    report["checkpoint"] = os.path.basename(pth_path)
    report["n_utterances"] = len(mels)
    return report
