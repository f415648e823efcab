"""Training of the non-autoregressive iSTFT vocoder (port of
dvc_tpu/train/istft_vocoder_trainer.py).

The objective is the GAN-free core of the FreeV / Autovocoder recipe
(PAPERS.md): a multi-resolution STFT loss (spectral convergence plus
log-magnitude L1 over three framing grids) and 0.1 x a waveform L1.  The
optimizer is dvc_tpu's ``optax.chain(clip_by_global_norm(1.0),
adamw(2e-4, weight_decay=1e-5))``, written out formula for formula
(``ClipAdamW``).  One step is eager on the device: cuDNN convolutions and
cuFFT, float32 with TF32 off.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from dvc_tpu_torch.config import AudioConfig, ISTFTVocoderConfig, VocoderConfig
from dvc_tpu_torch.convert.griffinlim import istft
from dvc_tpu_torch.models.istft_vocoder import ISTFTVocoder
from dvc_tpu_torch.ops.stft import _window, frame_signal
from dvc_tpu_torch.train.checkpoint import _sorted_tree
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import istft_tree_from_state_dict
from dvc_tpu_torch.utils.device import device_constant, resolve_device, use_exact_float32

# (fft, hop) grids of the multi-resolution loss
RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))


def _stft_mag(wav: torch.Tensor, fft: int, hop: int) -> torch.Tensor:
    frames = frame_signal(wav, fft, hop)
    win = device_constant(_window, ("hann", fft), wav.device)
    return torch.fft.rfft(frames * win, n=fft, dim=-1).abs() + 1e-7


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over RESOLUTIONS of spectral convergence + log-magnitude L1.
    The spectral convergence is one Frobenius ratio over the whole batch
    (``jnp.linalg.norm`` of a 3-D array flattens it), not a mean per item."""
    total = 0.0
    for fft, hop in RESOLUTIONS:
        p = _stft_mag(pred, fft, hop)
        t = _stft_mag(target, fft, hop)
        sc = torch.linalg.vector_norm(t - p) / torch.clamp(torch.linalg.vector_norm(t),
                                                           min=1e-6)
        logmag = torch.mean(torch.abs(torch.log(t) - torch.log(p)))
        total = total + sc + logmag
    return total / len(RESOLUTIONS)


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay))`` over a list of parameters, in optax's formulas.

    The gradients are scaled by max_norm / norm when their global norm is
    at least max_norm (no epsilon, unlike ``clip_grad_norm_``); the update
    is -lr (m_hat / (sqrt(v_hat) + eps) + wd p) over every parameter,
    biases and LayerNorms included.  (``torch.optim.AdamW`` multiplies p by
    1 - lr wd first, which rounds to 1 in float32 at these rates.)"""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 2e-4,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-5):
        self.params = list(params)
        self.lr, self.max_norm, self.b1, self.b2 = lr, max_norm, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        # optax selects t or (t / norm) * max_norm; dividing by
        # max(norm, max_norm) and multiplying back is the same select
        denom = torch.clamp(norm, min=self.max_norm)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g / denom * self.max_norm
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.weight_decay * p
            p.add_(upd, alpha=-self.lr)


def make_istft_step(model: ISTFTVocoder, optimizer: ClipAdamW,
                    wav_l1_weight: float = 0.1) -> Callable:
    """Build step(mel, wav) -> (total, mrstft, l1), detached: the mel's
    synthesis at wav's length against wav, then the optimizer's update."""
    audio = model.audio

    def step(mel: torch.Tensor, wav: torch.Tensor):
        pred = istft(model(mel), wav.shape[-1], audio)
        mrstft = multi_resolution_stft_loss(pred, wav)
        l1 = torch.mean(torch.abs(pred - wav))
        total = mrstft + wav_l1_weight * l1
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        return total.detach(), mrstft.detach(), l1.detach()

    return step


@dataclass
class ISTFTVocoderTrainer:
    """Host loop of the iSTFT vocoder's training (dvc_tpu's
    ISTFTVocoderTrainer); the weights are drawn from ``seed``."""

    cfg: ISTFTVocoderConfig = ISTFTVocoderConfig()
    audio: AudioConfig = field(default_factory=AudioConfig)
    lr: float = 2e-4
    seed: int = 0
    device: str | torch.device = "cuda"
    step: int = field(default=0, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        use_exact_float32()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = ISTFTVocoder(self.cfg, self.audio)
        self.model = self.model.to(self.device).train()
        self.optimizer = ClipAdamW(self.model.parameters(), lr=self.lr)
        self.step_fn = make_istft_step(self.model, self.optimizer)

    def train_steps(self, batches, n_steps: int, logging_func=print) -> list[float]:
        """batches yields (mel (B, n_mels, T), wav (B, T * hop)) numpy
        pairs, as mel_wav_batches does; returns each step's total loss."""
        losses = []
        for i, (mel, wav) in enumerate(batches):
            if i >= n_steps:
                break
            mel, wav = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
                        for a in (mel, wav))
            total, mrstft, l1 = self.step_fn(mel, wav)
            self.step += 1
            if (i + 1) % 50 == 0 or i == 0:
                logging_func(f"istft-voc step {self.step}: loss {total.item():.4f} "
                             f"(mrstft {mrstft.item():.4f} l1 {l1.item():.4f})")
            losses.append(total)
        return torch.stack(losses).tolist() if losses else []

    def save(self, models_dir: str, run_id: str = "istft_voc") -> str:
        """Write the parameters (there is no EMA) as
        ``{run_id}_step{step:09d}.msgpack`` holding ``{"params": tree}`` in
        dvc_tpu's layout, dicts sorted as a trained state's are."""
        os.makedirs(models_dir, exist_ok=True)
        path = os.path.join(models_dir, f"{run_id}_step{self.step:09d}.msgpack")
        tree = _sorted_tree(istft_tree_from_state_dict(self.model.state_dict()))
        with open(path, "wb") as f:
            f.write(msgpack.packb({"params": tree}))
        return path


def mel_wav_batches(wav_dir: str, batch_size: int, crop_frames: int,
                    audio: AudioConfig = AudioConfig(), seed: int = 0):
    """Infinite (mel (B, n_mels, T), wav (B, T * hop)) pairs: a thin adapter
    over train/vocoder_trainer.wav_batches (the same load, resample,
    filter, crop and mel)."""
    from dvc_tpu_torch.train.vocoder_trainer import wav_batches

    # the crops align only if the WaveNet's hop equals the mel hop
    vcfg = VocoderConfig()
    if int(np.prod(vcfg.upsample_scales)) != audio.hop_size:
        raise ValueError(f"hop {audio.hop_size} != the vocoder's "
                         f"{int(np.prod(vcfg.upsample_scales))}")
    for x, c in wav_batches(wav_dir, batch_size, crop_frames * audio.hop_size, vcfg,
                            seed=seed, audio_cfg=audio):
        yield np.transpose(c, (0, 2, 1)), x[..., 0]
