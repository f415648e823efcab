"""AutoVC baselines (port of dvc_tpu/models/autovc.py).

Three generators, parity with reference autovc_replicate/:
  * AutoVC         - original AutoVC (original_autovc.py:295-328): a content
    encoder conditioned on the source speaker embedding, bottleneck codes
    down- and up-sampled at ``freq``, a decoder conditioned on the target
    embedding;
  * AutoVCF0       - the F0-conditioned variant (original_autovc.py:262-292):
    the decoder input gains 205 quantized-pitch dims;
  * ProposedAutoVC - the paper's ablation (proposed_autovc.py:187-220): a
    plain autoencoder T*128 -> latent -> T*128 with no speaker input.

Inputs and outputs are (B, T, n_mels), as dvc_tpu's; the convolutions run
on (B, C, T).  Modules carry dvc_tpu's names (utils/convert.py maps the
trees).  The strided code sampling is a reshape and the code upsampling a
``repeat_interleave``.  BatchNorms are the port's (groups 1): train mode
normalizes by the batch, eval mode by the running statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from dvc_tpu_torch.config import AutoVCConfig
from dvc_tpu_torch.models.layers import BatchNorm, ConvNorm, LinearNorm

F0_DIMS = 205  # original_autovc.py:262-292


def _conv_bn(cin: int, cout: int, gain: str) -> tuple[ConvNorm, BatchNorm]:
    return ConvNorm(cin, cout, 5, w_init_gain=gain, bias_init_value=None), BatchNorm(cout)


class _ContentEncoder(nn.Module):
    """original_autovc.py:41-81: conv stack + biLSTM + strided code sampling."""

    def __init__(self, cfg: AutoVCConfig):
        super().__init__()
        self.cfg = cfg
        cin = cfg.num_mels + cfg.dim_emb
        for i in range(3):
            conv, bn = _conv_bn(cin if i == 0 else 512, 512, "relu")
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", bn)
        self.lstm = nn.LSTM(512, cfg.dim_neck, 2, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor, c_org: torch.Tensor) -> torch.Tensor:
        """x (B, T, n_mels), c_org (B, dim_emb) -> codes (B, T / freq, 2 * neck)."""
        cfg = self.cfg
        b, t, _ = x.shape
        h = torch.cat([x, c_org[:, None, :].expand(b, t, c_org.shape[-1])], -1).transpose(1, 2)
        for i in range(3):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        out, _ = self.lstm(h.transpose(1, 2))
        fwd, bwd = out[..., :cfg.dim_neck], out[..., cfg.dim_neck:]
        # forward tap at each block's end, backward tap at its start
        # (original_autovc.py:77-79)
        n_codes = t // cfg.freq
        fwd_codes = fwd.reshape(b, n_codes, cfg.freq, cfg.dim_neck)[:, :, -1]
        bwd_codes = bwd.reshape(b, n_codes, cfg.freq, cfg.dim_neck)[:, :, 0]
        return torch.cat([fwd_codes, bwd_codes], -1)


class _Decoder(nn.Module):
    """original_autovc.py:133-171 (Decoder) / :222-260 (Decoder2)."""

    def __init__(self, cfg: AutoVCConfig, in_dim: int):
        super().__init__()
        self.lstm1 = nn.LSTM(in_dim, cfg.dim_pre, 1, batch_first=True)
        for i in range(3):
            conv, bn = _conv_bn(cfg.dim_pre, cfg.dim_pre, "relu")
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", bn)
        self.lstm2 = nn.LSTM(cfg.dim_pre, 1024, 2, batch_first=True)
        self.linear_projection = LinearNorm(1024, cfg.num_mels, bias_init_value=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.lstm1(x)
        h = h.transpose(1, 2)
        for i in range(3):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        h, _ = self.lstm2(h.transpose(1, 2))
        return self.linear_projection(h)


class _Postnet(nn.Module):
    """original_autovc.py:174-218: five conv + BatchNorm layers, tanh
    between them; (B, T, n_mels) in and out."""

    def __init__(self, cfg: AutoVCConfig):
        super().__init__()
        for i in range(5):
            conv, bn = _conv_bn(cfg.num_mels if i == 0 else 512,
                                cfg.num_mels if i == 4 else 512,
                                "linear" if i == 4 else "tanh")
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for i in range(5):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            if i < 4:
                h = torch.tanh(h)
        return h.transpose(1, 2)


class AutoVC(nn.Module):
    """Original AutoVC generator (original_autovc.py:295-328).

    forward(x, c_org, c_trg, f0=None): x is (B, T, n_mels) with T a multiple
    of ``freq``; returns (mel, mel_postnet, codes_flat), or only the
    flattened codes (B, T / freq * 2 * neck) when c_trg is None (the
    reference's conversion-time encoder probe).  With ``f0_dims`` the
    decoder also takes f0: per utterance (B, f0_dims), broadcast over the
    frames as the reference does (original_autovc.py:281), or per frame
    (B, T, f0_dims)."""

    def __init__(self, cfg: AutoVCConfig = AutoVCConfig(), f0_dims: int = 0):
        super().__init__()
        self.cfg = cfg
        self.f0_dims = f0_dims
        self.encoder = _ContentEncoder(cfg)
        self.decoder = _Decoder(cfg, 2 * cfg.dim_neck + cfg.dim_emb + f0_dims)
        self.postnet = _Postnet(cfg)

    def forward(self, x: torch.Tensor, c_org: torch.Tensor, c_trg: torch.Tensor | None,
                f0: torch.Tensor | None = None):
        codes = self.encoder(x, c_org)
        b, n_codes, code_dim = codes.shape
        codes_flat = codes.reshape(b, n_codes * code_dim)
        if c_trg is None:
            return codes_flat
        t = x.shape[1]
        parts = [codes.repeat_interleave(t // n_codes, dim=1),
                 c_trg[:, None, :].expand(b, t, c_trg.shape[-1])]
        if self.f0_dims:
            if f0 is None:
                raise ValueError("AutoVCF0 needs f0")
            if f0.dim() == 2:
                f0 = f0[:, None, :].expand(b, t, self.f0_dims)
            if tuple(f0.shape) != (b, t, self.f0_dims):
                raise ValueError(f"f0 of shape {tuple(f0.shape)}, expected "
                                 f"({b}, {t}, {self.f0_dims})")
            parts.append(f0)
        mel = self.decoder(torch.cat(parts, -1))
        return mel, mel + self.postnet(mel), codes_flat


def AutoVCF0(cfg: AutoVCConfig = AutoVCConfig()) -> AutoVC:
    """F0-conditioned variant (original_autovc.py:262-292): +205 decoder dims."""
    return AutoVC(cfg, f0_dims=F0_DIMS)


class ProposedAutoVC(nn.Module):
    """The paper's no-speaker-input autoencoder (proposed_autovc.py:187-220),
    for crops of ``frames`` frames (its latent is a Linear over all of
    them).  forward(x (B, frames, n_mels)) -> (mel, mel_postnet)."""

    def __init__(self, cfg: AutoVCConfig = AutoVCConfig(), frames: int = 64):
        super().__init__()
        self.cfg = cfg
        self.frames = frames
        for i in range(3):
            conv, bn = _conv_bn(cfg.num_mels if i == 0 else 512, 512, "relu")
            self.add_module(f"enc_conv{i}", conv)
            self.add_module(f"enc_bn{i}", bn)
        neck2 = 2 * cfg.proposed_dim_neck
        self.enc_lstm = nn.LSTM(512, cfg.proposed_dim_neck, 2, batch_first=True,
                                bidirectional=True)
        self.latent_code = LinearNorm(frames * neck2, cfg.proposed_latent_dim,
                                      bias_init_value=None)
        self.dec_linear = LinearNorm(cfg.proposed_latent_dim, frames * neck2,
                                     bias_init_value=None)
        self.dec_lstm1 = nn.LSTM(neck2, cfg.dim_pre, 1, batch_first=True)
        for i in range(3):
            conv, bn = _conv_bn(cfg.dim_pre, cfg.dim_pre, "relu")
            self.add_module(f"dec_conv{i}", conv)
            self.add_module(f"dec_bn{i}", bn)
        self.dec_lstm2 = nn.LSTM(cfg.dim_pre, 1024, 2, batch_first=True)
        self.linear_projection = LinearNorm(1024, cfg.num_mels, bias_init_value=None)
        self.postnet = _Postnet(cfg)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, t, _ = x.shape
        h = x.transpose(1, 2)
        for i in range(3):
            h = torch.relu(getattr(self, f"enc_bn{i}")(getattr(self, f"enc_conv{i}")(h)))
        h, _ = self.enc_lstm(h.transpose(1, 2))
        latent = self.latent_code(h.reshape(b, -1))
        d = self.dec_linear(latent).reshape(b, t, 2 * self.cfg.proposed_dim_neck)
        d, _ = self.dec_lstm1(d)
        d = d.transpose(1, 2)
        for i in range(3):
            d = torch.relu(getattr(self, f"dec_bn{i}")(getattr(self, f"dec_conv{i}")(d)))
        d, _ = self.dec_lstm2(d.transpose(1, 2))
        mel = self.linear_projection(d)
        return mel, mel + self.postnet(mel)
