"""Vocoder: normalized mel (80, T) -> waveform (port of
dvc_tpu/convert/vocode.py).

T mel frames -> T * hop samples, batched over utterances, through either
  * the WaveNet's autoregressive MoL sampler (reference
    preprocessing/processing.py:45-74): kernels/wavenet_step.generate, as
    dvc_tpu's make_vocoder calls pallas_generate: on cuda the hand-written
    CUDA kernel with bf16 weights, as dvc_tpu's Pallas path packs them; on
    the CPU its plain PyTorch version with float32 weights; or
  * the non-autoregressive iSTFT vocoder (make_istft_vocoder): one forward
    pass and an overlap-add iSTFT.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from dvc_tpu_torch.config import AudioConfig, ISTFTVocoderConfig, VocoderConfig
from dvc_tpu_torch.kernels.wavenet_step import generate
from dvc_tpu_torch.models.istft_vocoder import ISTFTVocoder, synthesize
from dvc_tpu_torch.models.wavenet import WaveNet
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import (fuse_weight_norm, istft_state_dict_from_jax,
                                         load_torch_state_dict, wavenet_state_dict_from_jax)
from dvc_tpu_torch.utils.device import resolve_device


def load_vocoder_params(ckpt_path: str) -> dict[str, torch.Tensor]:
    """Vocoder weights as the port's state dict, from a torch .pth/.pt (the
    reference's r9y9 checkpoint, weight norm fused) or, for any other name,
    dvc_tpu's msgpack ``{"params": ...}`` tree (dvc_tpu/convert/vocode.py:
    21-34, as its vocoder trainers write it)."""
    if ckpt_path.endswith((".pth", ".pt")):
        return fuse_weight_norm(load_torch_state_dict(ckpt_path))
    return wavenet_state_dict_from_jax(_msgpack_params(ckpt_path))


def _msgpack_params(ckpt_path: str) -> dict:
    with open(ckpt_path, "rb") as f:
        tree = msgpack.unpackb(f.read())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{ckpt_path}: not a msgpack vocoder checkpoint (no 'params')")
    return tree["params"]


def load_istft_params(ckpt_path: str) -> dict[str, torch.Tensor]:
    """The iSTFT vocoder's weights as the port's state dict, from dvc_tpu's
    msgpack ``{"params": ...}`` (as either package's ISTFTVocoderTrainer
    writes it)."""
    return istft_state_dict_from_jax(_msgpack_params(ckpt_path))


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


def make_istft_vocoder(ckpt_path: str, cfg: ISTFTVocoderConfig | None = None,
                       audio: AudioConfig | None = None, pad_frames_to: int = 32,
                       device: str | torch.device = "cuda"
                       ) -> Callable[[np.ndarray], np.ndarray]:
    """The vocoder protocol over the iSTFT vocoder
    (dvc_tpu/convert/vocode.py:96-143): (80, T) mel -> (T * hop,) waveform
    in one feed-forward pass; ``.batch`` vocodes many mels as one batch,
    zero-padded to a bucket of ``pad_frames_to`` frames, synthesized at the
    bucket's length and cropped to each mel's T * hop samples."""
    dev = resolve_device(device)
    audio = audio or AudioConfig()
    model = ISTFTVocoder(cfg or ISTFTVocoderConfig(), audio)
    model.load_state_dict(load_istft_params(ckpt_path))
    model = model.to(dev).eval()
    hop = audio.hop_size

    def wavegen(mel: np.ndarray) -> np.ndarray:
        return wavegen_batch([mel])[0]

    @torch.inference_mode()
    def wavegen_batch(mels: list[np.ndarray]) -> list[np.ndarray]:
        if not mels:
            return []
        ts = [m.shape[1] for m in mels]
        bucket = -(-max(ts) // pad_frames_to) * pad_frames_to
        c = np.zeros((len(mels), mels[0].shape[0], bucket), np.float32)
        for i, m in enumerate(mels):
            c[i, :, :m.shape[1]] = np.asarray(m, np.float32)
        wavs = synthesize(model, torch.from_numpy(c).to(dev), bucket * hop).cpu().numpy()
        return [wavs[i, : t * hop] for i, t in enumerate(ts)]

    wavegen.batch = wavegen_batch  # type: ignore[attr-defined]
    return wavegen
