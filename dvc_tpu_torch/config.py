"""Typed configuration: the dataclasses the serving path reads.

A copy of dvc_tpu/config.py's AudioConfig, VAEConfig, VocoderConfig and
Config (the port imports nothing of dvc_tpu), cut to the fields the port
reads; names and defaults are dvc_tpu's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class AudioConfig:
    """Audio/DSP parameters (reference preprocessing/hparams.py:39-111)."""

    sample_rate: int = 16_000
    num_mels: int = 80
    fmin: float = 90.0
    fmax: float = 7600.0
    fft_size: int = 1024
    hop_size: int = 256
    min_level_db: float = -100.0
    ref_level_db: float = 16.0
    # lws' default analysis window is sqrt(hann)
    window: str = "sqrt_hann"


@dataclass(frozen=True)
class VAEConfig:
    """DisentangledVAE architecture (reference model/disentangled_vae.py:124-195)."""

    num_mels: int = 80
    frames: int = 64              # samples_length; the encoder flattens T*2*dim_neck
    latent_dim: int = 32
    speaker_size: int = 4
    dim_neck: int = 64
    dim_pre: int = 512
    enc_channels: int = 512
    enc_lstm_layers: int = 2
    dec_lstm2_hidden: int = 1024
    postnet_channels: int = 512
    postnet_layers: int = 5
    kernel_size: int = 5
    bn_momentum: float = 0.9      # flax momentum = 1 - torch 0.1
    bn_eps: float = 1e-5

    @property
    def content_size(self) -> int:
        return self.latent_dim - self.speaker_size

    @property
    def flat_size(self) -> int:
        return self.frames * 2 * self.dim_neck


@dataclass(frozen=True)
class VocoderConfig:
    """WaveNet vocoder (reference preprocessing/hparams.py:82-117)."""

    out_channels: int = 30            # 10 mixtures x 3 (pi, mean, log_scale)
    layers: int = 24
    stacks: int = 4
    residual_channels: int = 512
    gate_channels: int = 512
    skip_out_channels: int = 256
    kernel_size: int = 3
    cin_channels: int = 80
    upsample_scales: Sequence[int] = (4, 4, 4, 4)
    freq_axis_kernel_size: int = 3
    log_scale_min: float = -32.23619130191664
    legacy: bool = True                # x sqrt(1/2) skip scaling

    @property
    def layers_per_stack(self) -> int:
        return self.layers // self.stacks

    def dilation(self, layer: int) -> int:
        return 2 ** (layer % self.layers_per_stack)


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
