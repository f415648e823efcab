"""Typed configuration: the dataclasses the serving and training paths read.

A copy of dvc_tpu/config.py's AudioConfig, VAEConfig, LossConfig,
TrainConfig, VocoderConfig, ISTFTVocoderConfig, SpeakerEncoderConfig,
AutoVCConfig, MeshConfig and Config (the port imports nothing of dvc_tpu),
with dvc_tpu's names, defaults and field order, so that ``Config().to_json()``
and the config.json that ``train`` writes are dvc_tpu's byte for byte.
Some fields are records only, read by nothing in the port:
``allow_clipping_in_normalization``, ``inference_n_frames``,
``gin_channels`` and ``weight_normalization`` (as in dvc_tpu),
``donate_state`` (there is no jit to donate to).  MeshConfig lays the
train mesh over the ranks of a process group (parallel/mesh.py).
``checkpoint_format="orbax"`` writes dvc_tpu's sharded orbax checkpoint
(train/checkpoint.py), read and written without orbax.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence


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
    rescaling: bool = True
    rescaling_max: float = 0.999
    # a record (ops/mel.py always clips to [0, 1], as the reference runs)
    allow_clipping_in_normalization: bool = True
    # lws' default analysis window is sqrt(hann)
    window: str = "sqrt_hann"

    # VAD (preprocessing/encoder/params_data.py:17-24; detector role of
    # webrtcvad.Vad(mode=3) at encoder/audio.py:97)
    vad_window_length_ms: int = 30
    vad_moving_average_width: int = 8
    vad_max_silence_length: int = 6
    vad_detector: str = "gmm"  # "gmm" (WebRTC-architecture) | "energy"
    vad_mode: int = 3          # webrtcvad aggressiveness 0..3
    audio_norm_target_dbfs: float = -30.0

    # partial-utterance windows of the speaker encoder
    # (preprocessing/encoder/params_data.py:11-13); the second a record
    partials_n_frames: int = 63
    inference_n_frames: int = 80


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
    # run the GVAE pair as one 2B-batch pass with per-half (grouped)
    # BatchNorm statistics; the unfused path runs each half on its own
    pair_fused: bool = True

    @property
    def content_size(self) -> int:
        return self.latent_dim - self.speaker_size

    @property
    def flat_size(self) -> int:
        return self.frames * 2 * self.dim_neck


@dataclass(frozen=True)
class LossConfig:
    """Loss coefficients (reference train.py:42-45, model/disentangled_vae.py:310-327)."""

    mse_cof: float = 10.0
    kl_cof: float = 10.0
    style_cof: float = 0.1       # computed/logged but NOT in the total (parity quirk)
    beta_cof: float = 0.1
    adv_cof: float = 0.0         # > 0: the adversarial content regularizer
    adv_speakers: int = 0        # its classifier's width, the corpus speaker count
    adv_lr: float = 1e-3
    adv_mode: str = "confusion"


@dataclass(frozen=True)
class TrainConfig:
    """Trainer settings (reference training.sh:1-13, train.py:13-47)."""

    batch_size: int = 8
    learning_rate: float = 1e-4
    epochs: int = 200_000
    report_interval: int = 50
    seed: int = 1
    samples_length: int = 64
    # "bfloat16" rounds the two input batches to bf16; the model computes in
    # float32 either way, as dvc_tpu's does (its layers promote bf16 inputs
    # with float32 parameters back to float32)
    compute_dtype: str = "bfloat16"
    donate_state: bool = True         # a record: there is no jit to donate to
    remat: bool = False               # recompute the pair forward in the backward
    checkpoint_format: str = "msgpack"  # or "orbax"; either beside .pth


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
    dropout: float = 1 - 0.95         # on the layer inputs, in training only
    cin_channels: int = 80
    gin_channels: int = -1            # a record: global conditioning is off
    upsample_scales: Sequence[int] = (4, 4, 4, 4)
    freq_axis_kernel_size: int = 3
    log_scale_min: float = -32.23619130191664
    # a record: the reference trains with weight_norm, the port's convs are
    # plain (the converters fuse g * v / ||v||)
    weight_normalization: bool = True
    legacy: bool = True                # x sqrt(1/2) skip scaling

    @property
    def layers_per_stack(self) -> int:
        return self.layers // self.stacks

    def dilation(self, layer: int) -> int:
        return 2 ** (layer % self.layers_per_stack)


@dataclass(frozen=True)
class ISTFTVocoderConfig:
    """Non-autoregressive iSTFT-head vocoder (FreeV / Autovocoder direction,
    PAPERS.md): a dilated convnet refines the pseudo-inverse-mel magnitude
    prior and predicts phase; the waveform is one overlap-add iSTFT."""

    channels: int = 512
    blocks: int = 8                       # dilated residual conv blocks
    kernel_size: int = 7
    dilation_cycle: Sequence[int] = (1, 2, 4, 8)


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    """GE2E speaker encoder (reference: preprocessing/encoder/params_model.py:1-11)."""

    mel_n_channels: int = 80
    hidden_size: int = 256
    embedding_size: int = 256
    num_layers: int = 3
    speakers_per_batch: int = 64
    utterances_per_speaker: int = 10
    learning_rate: float = 1e-4
    partials_n_frames: int = 63


@dataclass(frozen=True)
class AutoVCConfig:
    """AutoVC baselines (reference: autovc_replicate/original_autovc.py:295-328,
    proposed_autovc.py:187-220)."""

    dim_neck: int = 32
    dim_emb: int = 256
    dim_pre: int = 512
    freq: int = 32
    num_mels: int = 80
    # "proposed" plain-autoencoder variant
    proposed_dim_neck: int = 64
    proposed_latent_dim: int = 256


@dataclass(frozen=True)
class MeshConfig:
    """dvc_tpu's device-mesh settings: the data and model axes' names and
    sizes (data_parallel -1: every rank the model axis leaves), and ZeRO
    sharding of Adam's moments over the data axis.  The Trainer lays this
    mesh over the ranks of a process group (parallel/mesh.py); one process
    without one trains as a one-device mesh."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1
    shard_opt_state: bool = True


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    speaker_encoder: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    autovc: AutoVCConfig = field(default_factory=AutoVCConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, default=str)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def training_preset() -> Config:
    """Hyperparameters of the canonical training run (reference
    training.sh:1-13: 200k epochs, bs=8, lr=1e-4, latent 32, speaker 4,
    64-frame samples): the defaults."""
    return Config()


@dataclass(frozen=True)
class ConversionSpec:
    """The conversion run's identity (reference conversion.sh:2-3,13-14)."""

    src_spk: str
    trg_spk: str
    num_utterances: int = 2  # the reference converts the first 2 sorted utts
                             # (variational_base_vae.py:264)


def conversion_preset(src_spk: str = "VCTK-Corpus_wav16_p225",
                      trg_spk: str = "VCTK-Corpus_wav16_p226"
                      ) -> tuple[Config, ConversionSpec]:
    """Conversion-time settings (reference conversion.sh:1-14).  The Config
    is the training preset: conversion.sh passes --samples_length=128, but
    the reference's chunking_mel hardcodes 64-frame chunks
    (variational_base_vae.py:337) and the VAE takes no other length."""
    return Config(), ConversionSpec(src_spk, trg_spk)
