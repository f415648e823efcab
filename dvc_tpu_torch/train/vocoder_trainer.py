"""WaveNet vocoder training: teacher-forced forward, MoL NLL, Adam and an EMA
trail (port of dvc_tpu/train/vocoder_trainer.py).

The recipe is the reference vocoder's (preprocessing/hparams.py:129-151):
Adam 1e-3, betas (0.9, 0.999), eps 1e-8, crops of 8000 samples, and an
exponential moving average of the weights with decay 0.9999, ramped as
min(0.9999, (1 + t) / (10 + t)).  One step is eager on the device: cuDNN
dilated convolutions in exact float32 (TF32 off), as the VAE's train step.
The saved checkpoint is the EMA trail, in dvc_tpu's msgpack layout, which
``convert/vocode.load_vocoder_params`` and dvc_tpu's ``make_vocoder`` read.

While a torch.profiler records, each step records the VAE trainer's spans
(utils/profiling.py): ``train.data_wait`` (the inline draw of crops and
their CPU mel), ``train.h2d``, ``train.forward`` (upsampler, WaveNet and
the MoL NLL), ``train.backward`` (``zero_grad`` and the backward),
``train.optimizer`` (Adam) and ``train.ema`` (the trail's update).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from dvc_tpu_torch.config import AudioConfig, VocoderConfig
from dvc_tpu_torch.models.layers import flax_init_
from dvc_tpu_torch.models.wavenet import WaveNet, discretized_mix_logistic_loss
from dvc_tpu_torch.train.checkpoint import _sorted_tree
from dvc_tpu_torch.train.trainer import _step_seed, make_optimizer
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import wavenet_tree_from_state_dict
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32
from dvc_tpu_torch.utils.profiling import span

EMA_DECAY = 0.9999


def create_wavenet(cfg: VocoderConfig, seed: int = 0,
                   device: str | torch.device = "cuda") -> WaveNet:
    """A fresh WaveNet on ``device`` with flax's default init, drawn from
    ``seed``; the upsampler keeps its constant init (the global torch RNG
    is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = flax_init_(WaveNet(cfg))
    return model.to(resolve_device(device))


def ema_decay_at(t: int) -> float:
    """The EMA decay after step ``t`` (the count before the update),
    min(0.9999, (1 + t) / (10 + t)) in float32 as dvc_tpu computes it.
    Without the ramp a short run's trail would be mostly the initial
    weights (0.9999^1500 = 86%)."""
    t32 = np.float32(t)
    return float(min(np.float32(EMA_DECAY),
                     (np.float32(1.0) + t32) / (np.float32(10.0) + t32)))


@torch.no_grad()
def ema_update_(ema: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
                t: int) -> None:
    """ema <- d ema + (1 - d) params, in place, with d = ema_decay_at(t)."""
    d = ema_decay_at(t)
    for name, e in ema.items():
        e.mul_(d).add_(params[name], alpha=1.0 - d)


def make_wavenet_step(model: WaveNet, optimizer: torch.optim.Optimizer,
                      ema: dict[str, torch.Tensor], cfg: VocoderConfig) -> Callable:
    """Build step(x, c, t, generator=None) -> the NLL (detached).

    x (B, T, 1) in [-1, 1], c (B, T // hop, n_mels); the loss predicts
    x[t] from x[<t] (y_hat[:, :-1] against x[:, 1:]).  After Adam's update
    the EMA trail ``ema`` (name -> tensor, never the parameters themselves)
    moves toward the new parameters with decay ema_decay_at(t), t the step
    count before this step.  Dropout masks come from ``generator``."""
    params = dict(model.named_parameters())

    def step(x: torch.Tensor, c: torch.Tensor, t: int,
             generator: torch.Generator | None = None) -> torch.Tensor:
        with span("train.forward"):
            y_hat = model(x, c, train=True, generator=generator)
            loss = discretized_mix_logistic_loss(y_hat[:, :-1], x[:, 1:],
                                                 log_scale_min=cfg.log_scale_min)
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("train.optimizer"):
            optimizer.step()
        with span("train.ema"):
            ema_update_(ema, params, t)
        return loss.detach()

    return step


@dataclass
class VocoderTrainer:
    """Host loop of the WaveNet's training (dvc_tpu's VocoderTrainer); the
    weights are drawn from ``seed``, the dropout masks from (seed + 1,
    step), so a resumed run would draw what a straight one does."""

    cfg: VocoderConfig = VocoderConfig()
    lr: float = 1e-3
    seed: int = 0
    device: str | torch.device = "cuda"
    step: int = field(default=0, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        use_exact_float32()
        self.model = create_wavenet(self.cfg, self.seed, self.device).train()
        self.optimizer = make_optimizer(self.model, self.lr)
        # distinct tensors: the trail must never alias the parameters
        self.ema = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.step_fn = make_wavenet_step(self.model, self.optimizer, self.ema, self.cfg)
        self._gen = torch.Generator(device=self.device)

    def step_on(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """One train step on device tensors, with this step's dropout."""
        self._gen.manual_seed(_step_seed(self.seed + 1, self.step))
        loss = self.step_fn(x, c, self.step, self._gen)
        self.step += 1
        return loss

    def train_steps(self, batches, n_steps: int, logging_func=print) -> list[float]:
        """batches yields (x (B, T, 1) in [-1, 1], c (B, T // hop, n_mels))
        numpy arrays; returns each step's NLL."""
        losses = []
        it = iter(batches)
        for i in range(n_steps):
            with span("train.data_wait"):
                batch = next(it)
            with span("train.h2d"):
                x, c = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
                        for a in batch)
            losses.append(self.step_on(x, c))
            if i % 50 == 0:
                logging_func(f"vocoder step {self.step}: nll {losses[-1].item():.4f}")
        return torch.stack(losses).tolist() if losses else []

    def save(self, models_dir: str, run_id: str = "wavenet") -> str:
        """Write the EMA trail (the weights generation uses, as the
        reference's published checkpoint is) as
        ``{run_id}_step{step:09d}.msgpack`` holding ``{"params": tree}``,
        dvc_tpu's tree with its dicts sorted as a trained state's are: the
        bytes flax's ``to_bytes`` writes for it."""
        os.makedirs(models_dir, exist_ok=True)
        path = os.path.join(models_dir, f"{run_id}_step{self.step:09d}.msgpack")
        tree = _sorted_tree(wavenet_tree_from_state_dict(self.ema))
        with open(path, "wb") as f:
            f.write(msgpack.packb({"params": tree}))
        return path


def wav_batches(wav_dir: str, batch_size: int, max_time_steps: int,
                cfg: VocoderConfig, seed: int = 0, audio_cfg: AudioConfig | None = None):
    """Infinite (x (B, T, 1), c (B, T // hop, n_mels)) teacher-forcing
    batches from a directory of wavs (dvc_tpu's wav_batches draw for draw).

    The wavs (sorted recursive glob) are resampled to the audio rate and
    those shorter than a crop dropped.  Each draw picks random wavs and
    random hop-aligned crops of max_time_steps // hop * hop samples from
    ``np.random.RandomState(seed)`` in dvc_tpu's order, and takes their mel
    with the port's melspectrogram on the CPU, cut to exactly T // hop
    frames (the upsampler's contract)."""
    from dvc_tpu_torch.ops.audio import resample_poly
    from dvc_tpu_torch.ops.mel import melspectrogram
    from dvc_tpu_torch.utils.wavio import read_audio

    audio_cfg = audio_cfg or AudioConfig()
    hop = int(np.prod(cfg.upsample_scales))
    t = (max_time_steps // hop) * hop
    frames = t // hop
    fps = sorted(glob.glob(os.path.join(wav_dir, "**", "*.wav"), recursive=True))
    if not fps:
        raise FileNotFoundError(f"no wavs under {wav_dir}")
    wavs = []
    for fp in fps:
        w, sr = read_audio(fp)
        if sr != audio_cfg.sample_rate:
            w = resample_poly(torch.from_numpy(np.asarray(w, np.float32)), sr,
                              audio_cfg.sample_rate).numpy()
        if len(w) >= t:
            wavs.append(np.asarray(w, np.float32))
    if not wavs:
        raise ValueError(f"no wav under {wav_dir} is >= {t} samples")
    rng = np.random.RandomState(seed)
    while True:
        xs = np.zeros((batch_size, t, 1), np.float32)
        for b in range(batch_size):
            w = wavs[rng.randint(len(wavs))]
            start = rng.randint(0, len(w) - t + 1) // hop * hop
            xs[b, :, 0] = w[start:start + t]
        with torch.inference_mode():
            mel = melspectrogram(torch.from_numpy(xs[..., 0]), audio_cfg).numpy()
        yield xs, np.swapaxes(mel, 1, 2)[:, :frames]  # (B, frames, n_mels)
