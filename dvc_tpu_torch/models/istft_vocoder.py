"""Non-autoregressive iSTFT-head vocoder (port of
dvc_tpu/models/istft_vocoder.py).

Following the FreeV / Autovocoder direction (PAPERS.md), the network starts
from the pseudo-inverse-mel magnitude prior and learns only a log-magnitude
residual and a phase field; the waveform is one overlap-add iSTFT
(convert/griffinlim.istft).  Synthesis is one feed-forward pass: dilated
convolutions (cuDNN), then an irfft and an overlap-add (cuFFT, ``F.fold``).

The trunk runs in torch's (B, C, T); flax's channels-last kernels (K, Cin,
Cout) cross through utils/convert.istft_state_dict_from_jax.  LayerNorm
normalizes over channels with flax's epsilon, 1e-6.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.config import AudioConfig, ISTFTVocoderConfig
from dvc_tpu_torch.convert.griffinlim import (default_inversion_length, istft,
                                              mel_to_stft_magnitude)
from dvc_tpu_torch.models.layers import flax_init_

FLAX_LN_EPS = 1e-6


class _ChannelNorm(nn.LayerNorm):
    """flax's LayerNorm over the channels of a (B, C, T) tensor."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=FLAX_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class _Block(nn.Module):
    """Dilated residual conv block over (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2
        self.conv_a = nn.Conv1d(channels, channels, kernel_size, dilation=dilation,
                                padding=pad)
        self.conv_b = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_b(F.silu(self.conv_a(F.silu(x))))


class ISTFTVocoder(nn.Module):
    """mel (B, n_mels, T), [0, 1]-normalized -> complex64 STFT (B, T, n_freq).

    Built with flax's default init (lecun-normal kernels, zero biases),
    drawn from torch's global RNG; the magnitude head starts at zero, so an
    untrained model returns the pinv-mel prior's magnitudes."""

    def __init__(self, cfg: ISTFTVocoderConfig = ISTFTVocoderConfig(),
                 audio: AudioConfig = AudioConfig()):
        super().__init__()
        self.cfg, self.audio = cfg, audio
        n_freq = audio.fft_size // 2 + 1
        c = cfg.channels
        self.stem = nn.Conv1d(n_freq, c, 7, padding=3)
        # the norms keep the trunk's scale independent of the raw log
        # magnitude's range (about +-11): without them any drift of the
        # zero-init head multiplies O(30) activations (dvc_tpu's note)
        self.stem_norm = _ChannelNorm(c)
        self.blocks = nn.ModuleList(
            _Block(c, cfg.kernel_size, cfg.dilation_cycle[i % len(cfg.dilation_cycle)])
            for i in range(cfg.blocks))
        self.head_norm = _ChannelNorm(c)
        self.mag_head = nn.Conv1d(c, n_freq, 1)
        self.phase_head = nn.Conv1d(c, 2 * n_freq, 1)
        flax_init_(self)
        nn.init.zeros_(self.mag_head.weight)

    def forward(self, mel_norm: torch.Tensor) -> torch.Tensor:
        prior = mel_to_stft_magnitude(mel_norm, self.audio)  # (B, T, F)
        log_prior = torch.log(prior + 1e-5)
        n_freq = prior.shape[-1]
        h = self.stem_norm(self.stem(log_prior.transpose(1, 2)))
        for block in self.blocks:
            h = block(h)
        h = self.head_norm(F.silu(h))
        # magnitude: a learned log residual on the prior; phase: an
        # unnormalized (re, im) pair per bin, made a unit phasor
        log_res = self.mag_head(h).transpose(1, 2)
        mag = torch.exp(torch.clamp(log_prior + log_res, -11.5, 6.0))
        ri = self.phase_head(h).transpose(1, 2)
        re, im = ri[..., :n_freq], ri[..., n_freq:]
        norm = torch.sqrt(re * re + im * im + 1e-9)
        return torch.complex(mag * (re / norm), mag * (im / norm))


def synthesize(model: ISTFTVocoder, mel_norm: torch.Tensor,
               length: int | None = None) -> torch.Tensor:
    """mel (B, n_mels, T) -> waveform (B, length); the default length is the
    largest sample count framing to exactly T frames.  A length above
    T * hop is refused: the iSTFT's crop holds only T * hop samples."""
    t = mel_norm.shape[-1]
    if length is None:
        length = default_inversion_length(t, model.audio)
    if length > t * model.audio.hop_size:
        raise ValueError(f"length {length} exceeds the {t * model.audio.hop_size} samples "
                         f"a {t}-frame mel can synthesize")
    return istft(model(mel_norm), length, model.audio)
