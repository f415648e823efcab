"""Loss functions of the disentangled VAE (port of dvc_tpu/train/losses.py).

Reference model/disentangled_vae.py:309-327, the group-VAE objective of
"Weakly-Supervised Disentanglement Without Compromises", with its quirks:
  * the four L1 reconstruction terms are SUMS over all elements divided by
    the batch size (:314-318);
  * the two z-KL terms are per-sample sums over latent dims, then a batch
    MEAN (:320-321);
  * the style KL uses a factor of -1 (not -0.5) and a sum over everything
    divided by the batch (:323), and stays OUT of the total (:325);
  * total = mse_cof * (4 L1 terms) + kl_cof * (2 KL terms).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossTerms(NamedTuple):
    total: torch.Tensor
    mse_x1: torch.Tensor
    mse_x2: torch.Tensor
    mse_x1_hat: torch.Tensor
    mse_x2_hat: torch.Tensor
    z1_kl: torch.Tensor
    z2_kl: torch.Tensor
    z_style_kl: torch.Tensor


def _l1_sum_over_batch(x: torch.Tensor, y: torch.Tensor, batch_size: int) -> torch.Tensor:
    return (x - y).abs().sum().to(torch.float32) / batch_size


def _z_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * (1 + logvar - mu ** 2 - logvar.exp()).sum(-1).mean()


def gvae_pair_loss(x1, x2, recons_x1, recons_x2, recons_x1_hat, recons_x2_hat,
                   q_z1_mu, q_z1_logvar, q_z2_mu, q_z2_logvar,
                   style_mu, style_logvar,
                   mse_cof: float = 10.0, kl_cof: float = 10.0) -> LossTerms:
    """loss_functionGVAE2 (reference model/disentangled_vae.py:310-327)."""
    b = x1.shape[0]
    mse_x1 = _l1_sum_over_batch(x1, recons_x1, b)
    mse_x2 = _l1_sum_over_batch(x2, recons_x2, b)
    mse_x1_hat = _l1_sum_over_batch(x1, recons_x1_hat, b)
    mse_x2_hat = _l1_sum_over_batch(x2, recons_x2_hat, b)
    z1_kl = _z_kl(q_z1_mu, q_z1_logvar)
    z2_kl = _z_kl(q_z2_mu, q_z2_logvar)
    # factor -1 and excluded from the total, as in the reference (:323-325)
    z_style_kl = -1.0 * (1 + style_logvar - style_mu ** 2 - style_logvar.exp()).sum() / b
    total = mse_cof * (mse_x1 + mse_x2 + mse_x1_hat + mse_x2_hat) \
        + kl_cof * (z1_kl + z2_kl)
    return LossTerms(total, mse_x1, mse_x2, mse_x1_hat, mse_x2_hat,
                     z1_kl, z2_kl, z_style_kl)


def kl_delta_vae(mu: torch.Tensor, logvar: torch.Tensor, alpha: float = 0.95) -> torch.Tensor:
    """delta-VAE KL variant (reference model/disentangled_vae.py:334-345,353-354),
    vectorized over latent dims."""

    def f(x, coef=1.0):
        return coef * x - torch.log(x) - 1.0

    var = logvar.exp()
    first = f(var[:, 0]) + mu[:, 0] ** 2
    a2 = alpha * alpha
    rest = f(var[:, 1:] / (1 - a2)) \
        + ((mu[:, 1:] - alpha * mu[:, :-1]) ** 2 + a2 * logvar[:, :-1]) / (1 - a2)
    kl = first + rest.sum(-1)
    return -0.5 * kl.sum()
