"""Disentangled (speaker-style / content) VAE.

Port of dvc_tpu/models/disentangled_vae.py (reference
model/disentangled_vae.py:124-279): ``encode``, ``decode`` and ``postnet``
with the same (B, n_mels, T) layout at the public methods, and the
pairwise train forward.
Attribute names are the reference's state-dict names (the layout
tools/gen_parity_ckpt.py builds and dvc_tpu/utils/torch_convert.py reads):
enc_modules.{i}.{0.conv,1}, enc_lstm, enc_linear/style/content.linear_layer,
dec_pre_linear1|2, dec_lstm1|2, dec_modules.{i}.{0,1},
dec_linear2.linear_layer, postnet.convolutions.{i}.{0.conv,1}.

Pairwise forward (reference :250-279, dvc_tpu :156-215): both utterances of
a same-speaker pair are encoded; the second style posterior is detached,
the two style posteriors are averaged, and ONE z_style sample, drawn even
in eval mode, is concatenated with each utterance's content sample.
``pair_fused`` runs the pair as one 2B batch with per-half BatchNorm
statistics (layers.BatchNorm, groups = 2); unfused, each half runs on its
own.  The train/eval switch is the module's own (``model.train()`` /
``model.eval()``): it selects the BatchNorm statistics and whether the
content posteriors are sampled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.config import VAEConfig
from dvc_tpu_torch.models.layers import BatchNorm, ConvNorm, LinearNorm


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

    def __init__(self, cfg: VAEConfig, groups: int = 1):
        super().__init__()
        n = cfg.postnet_layers
        mods = []
        for i in range(n):
            cin = cfg.num_mels if i == 0 else cfg.postnet_channels
            cout = cfg.num_mels if i == n - 1 else cfg.postnet_channels
            mods.append(nn.Sequential(
                ConvNorm(cin, cout, cfg.kernel_size),
                BatchNorm(cout, cfg.bn_momentum, cfg.bn_eps, groups)))
        self.convolutions = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.convolutions[:-1]:
            x = torch.tanh(m(x))
        return self.convolutions[-1](x)


class DisentangledVAE(nn.Module):
    """encode / decode / postnet and the pairwise forward, with (B, n_mels, T)
    inputs and outputs.  ``pair_fused`` (dvc_tpu's module field, default
    False there too; the trainer passes VAEConfig.pair_fused) sets the
    BatchNorm groups; parameters and state dicts are the same either way."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), pair_fused: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.pair_fused = pair_fused
        g = 2 if pair_fused else 1
        self.enc_modules = nn.ModuleList(
            nn.Sequential(
                ConvNorm(c.num_mels if i == 0 else c.enc_channels,
                         c.enc_channels, c.kernel_size),
                BatchNorm(c.enc_channels, c.bn_momentum, c.bn_eps, g))
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
                          BatchNorm(c.dim_pre, c.bn_momentum, c.bn_eps, g))
            for _ in range(3))
        self.dec_lstm2 = nn.LSTM(c.dim_pre, c.dec_lstm2_hidden, 2, batch_first=True)
        self.dec_linear2 = LinearNorm(c.dec_lstm2_hidden, c.num_mels)

        self.postnet = Postnet(c, g)

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

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                generator: torch.Generator | None = None,
                eps: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None):
        """Pairwise forward of two (B, n_mels, T) batches.

        The noise comes from ``generator`` on the inputs' device, or from
        ``eps``, the standard-normal draws in the order dvc_tpu makes them:
        content1 (B, content), content2 (B, content), style (B, speaker).
        Returns (recons_x1, recons_x2, recons_x1_hat, recons_x2_hat,
        q_z1_mu, q_z1_logvar, q_z2_mu, q_z2_logvar, z_style_mu,
        z_style_logvar)."""
        if self.pair_fused:
            b = x1.shape[0]
            s_mu, s_lv, c_mu, c_lv = self.encode(torch.cat([x1, x2], 0))
            style_mu1, style_mu2 = s_mu[:b], s_mu[b:]
            style_lv1, style_lv2 = s_lv[:b], s_lv[b:]
            content_mu1, content_mu2 = c_mu[:b], c_mu[b:]
            content_lv1, content_lv2 = c_lv[:b], c_lv[b:]
        else:
            style_mu1, style_lv1, content_mu1, content_lv1 = self.encode(x1)
            style_mu2, style_lv2, content_mu2, content_lv2 = self.encode(x2)
        draws = iter(eps) if eps is not None else None

        def reparameterize(mu, logvar, sample):
            e = next(draws) if draws is not None else None
            if not sample:
                return mu
            if e is None:
                e = torch.randn(mu.shape, generator=generator, device=mu.device,
                                dtype=mu.dtype)
            return e * torch.exp(0.5 * logvar) + mu

        z_content1 = reparameterize(content_mu1, content_lv1, self.training)
        z_content2 = reparameterize(content_mu2, content_lv2, self.training)
        style_mu2, style_lv2 = style_mu2.detach(), style_lv2.detach()
        z_style_mu = (style_mu1 + style_mu2) / 2
        z_style_lv = (style_lv1 + style_lv2) / 2
        # reference :261 samples z_style in eval mode too
        z_style = reparameterize(z_style_mu, z_style_lv, True)

        z1 = torch.cat([z_style, z_content1], -1)
        z2 = torch.cat([z_style, z_content2], -1)
        q_z1_mu = torch.cat([z_style_mu, content_mu1], -1)
        q_z1_lv = torch.cat([z_style_lv, content_lv1], -1)
        q_z2_mu = torch.cat([z_style_mu, content_mu2], -1)
        q_z2_lv = torch.cat([z_style_lv, content_lv2], -1)

        if self.pair_fused:
            recons = self.decode(torch.cat([z1, z2], 0))
            recons_hat = recons + self.postnet(recons)
            recons_x1, recons_x2 = recons[:b], recons[b:]
            recons_x1_hat, recons_x2_hat = recons_hat[:b], recons_hat[b:]
        else:
            recons_x1 = self.decode(z1)
            recons_x2 = self.decode(z2)
            recons_x1_hat = recons_x1 + self.postnet(recons_x1)
            recons_x2_hat = recons_x2 + self.postnet(recons_x2)
        return (recons_x1, recons_x2, recons_x1_hat, recons_x2_hat,
                q_z1_mu, q_z1_lv, q_z2_mu, q_z2_lv, z_style_mu, z_style_lv)
