"""The DisentangledVAE, its pair loss and Adam, in plain PyTorch and float32.

A frozen copy of the published model (model/disentangled_vae.py:124-279 of
v-manhlt3/Disentangle-VAE-for-VC) with its state-dict names, so that the
state dict the benchmark makes from the seed loads into it and into the
program alike.  BatchNorm is written out: eval mode by the running
statistics; train mode by the batch's mean and biased variance per group
of the batch (the pair's two halves when the pair runs as one 2B batch).
The loss is loss_functionGVAE2 (:310-327) with its quirks (L1 sums over
the batch size; the style KL with factor -1 and out of the total), and
Adam is torch.optim.Adam's update written out (betas 0.9 and 0.999, eps
1e-8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class _Linear(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.linear_layer = nn.Linear(i, o)


class _Conv(nn.Module):
    def __init__(self, i, o, k):
        super().__init__()
        self.conv = nn.Conv1d(i, o, k, padding=(k - 1) // 2)


def _bn(c):
    return nn.BatchNorm1d(c)


class _Postnet(nn.Module):
    def __init__(self, vae: dict):
        super().__init__()
        n, m, pc, k = vae["postnet_layers"], vae["num_mels"], vae["postnet_channels"], vae["kernel_size"]
        self.convolutions = nn.ModuleList(
            nn.Sequential(_Conv(m if i == 0 else pc, m if i == n - 1 else pc, k),
                          _bn(m if i == n - 1 else pc))
            for i in range(n))


class RefVAE(nn.Module):
    """Parameters only; the arithmetic is in the functions below."""

    def __init__(self, vae: dict):
        super().__init__()
        self.vae = v = vae
        m, e, k, n = v["num_mels"], v["enc_channels"], v["kernel_size"], v["dim_neck"]
        p, flat = v["dim_pre"], v["frames"] * 2 * v["dim_neck"]
        self.enc_modules = nn.ModuleList(
            nn.Sequential(_Conv(m if i == 0 else e, e, k), _bn(e)) for i in range(3))
        self.enc_lstm = nn.LSTM(e, n, v["enc_lstm_layers"], batch_first=True,
                                bidirectional=True)
        self.enc_linear = _Linear(flat, 2048)
        self.style = _Linear(2048, 2 * v["speaker_size"])
        self.content = _Linear(2048, 2 * (v["latent_dim"] - v["speaker_size"]))
        self.dec_pre_linear1 = nn.Linear(v["latent_dim"], 2048)
        self.dec_pre_linear2 = nn.Linear(2048, flat)
        self.dec_lstm1 = nn.LSTM(2 * n, p, 1, batch_first=True)
        self.dec_modules = nn.ModuleList(
            nn.Sequential(nn.Conv1d(p, p, k, padding=(k - 1) // 2), _bn(p)) for _ in range(3))
        self.dec_lstm2 = nn.LSTM(p, v["dec_lstm2_hidden"], 2, batch_first=True)
        self.dec_linear2 = _Linear(v["dec_lstm2_hidden"], m)
        self.postnet = _Postnet(v)


def on_device(vae: dict, sd: dict, device) -> RefVAE:
    """A RefVAE holding ``sd``, built on the device without an init pass."""
    with torch.device("meta"):
        m = RefVAE(vae)
    m = m.to_empty(device=device)
    m.load_state_dict(sd)
    return m


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool, groups: int,
               eps: float) -> torch.Tensor:
    if not train:
        y = (x - bn.running_mean[:, None]) / torch.sqrt(bn.running_var[:, None] + eps)
        return y * bn.weight[:, None] + bn.bias[:, None]
    b, c, t = x.shape
    xg = x.reshape(groups, b // groups, c, t)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, c, t)
    return y * bn.weight[:, None] + bn.bias[:, None]


def _conv_bn(seq: nn.Sequential, x, train, groups, eps):
    conv = seq[0].conv if isinstance(seq[0], _Conv) else seq[0]
    return batch_norm(seq[1], conv(x), train, groups, eps)


def encode(m: RefVAE, x: torch.Tensor, train: bool = False, groups: int = 1):
    """(B, n_mels, T) -> (style_mu, style_logvar, content_mu, content_logvar)."""
    eps = m.vae["bn_eps"]
    for seq in m.enc_modules:
        x = F.relu(_conv_bn(seq, x, train, groups, eps))
    out, _ = m.enc_lstm(x.transpose(1, 2))
    out = F.relu(m.enc_linear.linear_layer(out.reshape(out.shape[0], -1)))
    st, ct = m.style.linear_layer(out), m.content.linear_layer(out)
    s, k = m.vae["speaker_size"], m.vae["latent_dim"] - m.vae["speaker_size"]
    return st[:, :s], st[:, s:], ct[:, :k], ct[:, k:]


def decode(m: RefVAE, z: torch.Tensor, train: bool = False, groups: int = 1):
    """(B, latent) -> (B, n_mels, T)."""
    eps = m.vae["bn_eps"]
    o = m.dec_pre_linear2(m.dec_pre_linear1(z))
    o, _ = m.dec_lstm1(o.view(z.shape[0], -1, 2 * m.vae["dim_neck"]))
    o = o.transpose(1, 2)
    for seq in m.dec_modules:
        o = F.relu(_conv_bn(seq, o, train, groups, eps))
    o, _ = m.dec_lstm2(o.transpose(1, 2))
    return m.dec_linear2.linear_layer(o).transpose(1, 2)


def postnet(m: RefVAE, x: torch.Tensor, train: bool = False, groups: int = 1):
    eps = m.vae["bn_eps"]
    convs = m.postnet.convolutions
    for seq in convs[:-1]:
        x = torch.tanh(_conv_bn(seq, x, train, groups, eps))
    return _conv_bn(convs[-1], x, train, groups, eps)


@torch.no_grad()
def target_style(m: RefVAE, chunks: torch.Tensor) -> torch.Tensor:
    """A target speaker's style: the mean style_mu over all its chunks."""
    return encode(m, chunks)[0].mean(0)


@torch.no_grad()
def convert(m: RefVAE, chunks: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """The latent swap: the source's content means, the target's style,
    decode + postnet, clamped to [0, 1]."""
    _, _, c_mu, _ = encode(m, chunks)
    z = torch.cat([style[None].expand(chunks.shape[0], -1), c_mu], -1)
    mel = decode(m, z)
    return torch.clamp(mel + postnet(m, mel), 0.0, 1.0)


def pair_loss(m: RefVAE, x1: torch.Tensor, x2: torch.Tensor, eps: tuple,
              mse_cof: float = 10.0, kl_cof: float = 10.0) -> torch.Tensor:
    """The total of loss_functionGVAE2 on the pair forward in train mode:
    both halves encoded as one 2B batch with per-half statistics; the second
    style posterior detached, the two averaged, one z_style sample for both;
    eps = the standard-normal draws (content1, content2, style)."""
    b = x1.shape[0]
    s_mu, s_lv, c_mu, c_lv = encode(m, torch.cat([x1, x2], 0), True, 2)
    e1, e2, es = eps
    zc1 = e1 * torch.exp(0.5 * c_lv[:b]) + c_mu[:b]
    zc2 = e2 * torch.exp(0.5 * c_lv[b:]) + c_mu[b:]
    st_mu = (s_mu[:b] + s_mu[b:].detach()) / 2
    st_lv = (s_lv[:b] + s_lv[b:].detach()) / 2
    zs = es * torch.exp(0.5 * st_lv) + st_mu
    z = torch.cat([torch.cat([zs, zc1], -1), torch.cat([zs, zc2], -1)], 0)
    rec = decode(m, z, True, 2)
    rec_hat = rec + postnet(m, rec, True, 2)
    x = torch.cat([x1, x2], 0)
    l1 = ((x - rec).abs().sum() + (x - rec_hat).abs().sum()) / b

    def kl(mu, lv):
        return -0.5 * (1 + lv - mu ** 2 - lv.exp()).sum(-1).mean()

    q1 = (torch.cat([st_mu, c_mu[:b]], -1), torch.cat([st_lv, c_lv[:b]], -1))
    q2 = (torch.cat([st_mu, c_mu[b:]], -1), torch.cat([st_lv, c_lv[b:]], -1))
    return mse_cof * l1 + kl_cof * (kl(*q1) + kl(*q2))


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad)."""

    def __init__(self, params: dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
