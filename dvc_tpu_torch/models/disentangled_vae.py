"""Disentangled (speaker-style / content) VAE — serving surface.

Port of dvc_tpu/models/disentangled_vae.py (reference
model/disentangled_vae.py:124-248): ``encode``, ``decode`` and ``postnet``
in eval mode, with the same (B, n_mels, T) layout at the public methods.
Attribute names are the reference's state-dict names (the layout
tools/gen_parity_ckpt.py builds and dvc_tpu/utils/torch_convert.py reads):
enc_modules.{i}.{0.conv,1}, enc_lstm, enc_linear/style/content.linear_layer,
dec_pre_linear1|2, dec_lstm1|2, dec_modules.{i}.{0,1},
dec_linear2.linear_layer, postnet.convolutions.{i}.{0.conv,1}.

The pairwise train forward (group-VAE objective) waits for the training
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.config import VAEConfig
from dvc_tpu_torch.models.layers import ConvNorm, LinearNorm, batch_norm


def _xavier_linear(in_dim: int, out_dim: int) -> nn.Linear:
    # the reference's init_weights pass reaches plain nn.Linear too (:26-31)
    lin = nn.Linear(in_dim, out_dim)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.constant_(lin.bias, 0.01)
    return lin


def _xavier_conv(in_ch: int, out_ch: int, k: int) -> nn.Conv1d:
    conv = nn.Conv1d(in_ch, out_ch, k, 1, (k - 1) // 2)
    nn.init.xavier_uniform_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class Postnet(nn.Module):
    """Five k=5 convs + BN; tanh after all but the last (reference :43-87)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        n = cfg.postnet_layers
        mods = []
        for i in range(n):
            cin = cfg.num_mels if i == 0 else cfg.postnet_channels
            cout = cfg.num_mels if i == n - 1 else cfg.postnet_channels
            mods.append(nn.Sequential(
                ConvNorm(cin, cout, cfg.kernel_size),
                batch_norm(cout, cfg.bn_momentum, cfg.bn_eps)))
        self.convolutions = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.convolutions[:-1]:
            x = torch.tanh(m(x))
        return self.convolutions[-1](x)


class DisentangledVAE(nn.Module):
    """encode / decode / postnet with (B, n_mels, T) inputs and outputs."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.enc_modules = nn.ModuleList(
            nn.Sequential(
                ConvNorm(c.num_mels if i == 0 else c.enc_channels,
                         c.enc_channels, c.kernel_size),
                batch_norm(c.enc_channels, c.bn_momentum, c.bn_eps))
            for i in range(3))
        self.enc_lstm = nn.LSTM(c.enc_channels, c.dim_neck, c.enc_lstm_layers,
                                batch_first=True, bidirectional=True)
        self.enc_linear = LinearNorm(c.flat_size, 2048)
        self.style = LinearNorm(2048, 2 * c.speaker_size)
        self.content = LinearNorm(2048, 2 * c.content_size)

        self.dec_pre_linear1 = _xavier_linear(c.latent_dim, 2048)
        self.dec_pre_linear2 = _xavier_linear(2048, c.flat_size)
        self.dec_lstm1 = nn.LSTM(2 * c.dim_neck, c.dim_pre, 1, batch_first=True)
        self.dec_modules = nn.ModuleList(
            nn.Sequential(_xavier_conv(c.dim_pre, c.dim_pre, c.kernel_size),
                          batch_norm(c.dim_pre, c.bn_momentum, c.bn_eps))
            for _ in range(3))
        self.dec_lstm2 = nn.LSTM(c.dim_pre, c.dec_lstm2_hidden, 2, batch_first=True)
        self.dec_linear2 = LinearNorm(c.dec_lstm2_hidden, c.num_mels)

        self.postnet = Postnet(c)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, n_mels, T) -> (style_mu, style_logvar, content_mu, content_logvar)."""
        for m in self.enc_modules:
            x = F.relu(m(x))
        out, _ = self.enc_lstm(x.transpose(1, 2))
        out = F.relu(self.enc_linear(out.reshape(out.shape[0], -1)))
        st, ct = self.style(out), self.content(out)
        s, k = self.cfg.speaker_size, self.cfg.content_size
        return st[:, :s], st[:, s:], ct[:, :k], ct[:, k:]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent) -> (B, n_mels, T)."""
        o = self.dec_pre_linear2(self.dec_pre_linear1(z))
        o, _ = self.dec_lstm1(o.view(z.shape[0], -1, 2 * self.cfg.dim_neck))
        o = o.transpose(1, 2)
        for m in self.dec_modules:
            o = F.relu(m(o))
        o, _ = self.dec_lstm2(o.transpose(1, 2))
        return self.dec_linear2(o).transpose(1, 2)

    # ``self.postnet(mel)`` is dvc_tpu's ``postnet`` method: the (B, n_mels, T)
    # residual, called through the submodule that owns the state-dict prefix
