"""Vocoder: normalized mel (80, T) -> waveform (port of
dvc_tpu/convert/vocode.py).

T mel frames -> T * hop samples through the WaveNet's autoregressive MoL
sampler (reference preprocessing/processing.py:45-74), batched over
utterances.  The sampler is kernels/wavenet_step.generate, as dvc_tpu's
make_vocoder calls pallas_generate: on cuda the hand-written CUDA kernel with bf16 weights, as
dvc_tpu's Pallas path packs them; on the CPU its plain PyTorch version with
float32 weights.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.kernels.wavenet_step import generate
from dvc_tpu_torch.models.wavenet import WaveNet
from dvc_tpu_torch.utils.convert import fuse_weight_norm, load_torch_state_dict
from dvc_tpu_torch.utils.device import resolve_device


def load_vocoder_params(ckpt_path: str) -> dict[str, torch.Tensor]:
    """Vocoder weights from a torch .pth (the reference's r9y9 checkpoint,
    weight norm fused).  dvc_tpu's own msgpack format is not read here."""
    if not ckpt_path.endswith((".pth", ".pt")):
        raise ValueError(f"{ckpt_path}: only .pth/.pt vocoder checkpoints are "
                         "read by the port")
    return fuse_weight_norm(load_torch_state_dict(ckpt_path))


def make_vocoder(ckpt_path: str | None, cfg: VocoderConfig = VocoderConfig(),
                 seed: int = 0, pad_frames_to: int = 32,
                 variables: Mapping[str, torch.Tensor] | None = None,
                 device: str | torch.device = "cuda"
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """Returns wavegen: (80, T) normalized mel -> (T * hop,) float waveform,
    with ``wavegen.batch(mels)`` vocoding many utterances in one pass.

    Mel frames are zero-padded to ``pad_frames_to`` buckets and the waveform
    is cropped to the true T * hop samples.  ``variables`` is an in-memory
    state dict (reference names, weight norm fused) used instead of a
    checkpoint file.  Every call draws with the same ``seed``, as dvc_tpu's
    make_vocoder does."""
    dev = resolve_device(device)
    wdt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if variables is None:
        variables = load_vocoder_params(ckpt_path)
    model = WaveNet(cfg)
    model.load_state_dict(variables)
    model = model.to(dev).eval()
    hop = model.hop

    def _generate(c: np.ndarray) -> np.ndarray:
        return generate(model, c, seed, weight_dtype=wdt, device=dev).cpu().numpy()

    def wavegen(mel: np.ndarray) -> np.ndarray:
        return wavegen_batch([mel])[0]

    def wavegen_batch(mels: list[np.ndarray]) -> list[np.ndarray]:
        """Vocode many utterances in one pass: mels are zero-padded to a
        common frame bucket and run as one batch."""
        if not mels:
            return []
        ts = [m.shape[1] for m in mels]
        bucket = -(-max(ts) // pad_frames_to) * pad_frames_to
        c = np.zeros((len(mels), bucket, mels[0].shape[0]), np.float32)
        for i, m in enumerate(mels):
            c[i, :m.shape[1]] = np.asarray(m, np.float32).T
        wavs = _generate(c)
        return [wavs[i, : t * hop] for i, t in enumerate(ts)]

    wavegen.batch = wavegen_batch  # type: ignore[attr-defined]
    return wavegen
