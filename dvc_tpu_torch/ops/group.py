"""Group-evidence utilities (port of dvc_tpu/ops/group.py; reference
model/utils.py:13-128, which the main GVAE path, like the reference's,
does not call):

  * accumulate_group_evidence: precision-weighted pooling of per-sample
    Gaussian posteriors into one posterior per group label;
  * group_wise_reparameterize: one shared eps draw per group;
  * permute_dims: FactorVAE's per-dimension batch shuffle.

The reference's per-sample dict loops (utils.py:29-72) are an
``index_add_`` over the labels, as dvc_tpu's ``segment_sum``.  Random
draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch


def _segment_sum(x: torch.Tensor, labels: torch.Tensor, num_groups: int) -> torch.Tensor:
    out = torch.zeros(num_groups, *x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, labels, x)


def accumulate_group_evidence(class_mu: torch.Tensor, class_logvar: torch.Tensor,
                              labels: torch.Tensor, num_groups: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D) posteriors and (B,) labels below ``num_groups`` -> (group_mu,
    group_logvar), each (B, D): every sample's group posterior
    (utils.py:13-75)."""
    labels = torch.as_tensor(labels, device=class_mu.device).long()
    inv_var = 1.0 / class_logvar.exp().clamp(min=1e-6)
    group_var = 1.0 / _segment_sum(inv_var, labels, num_groups).clamp(min=1e-6)
    group_mu = _segment_sum(class_mu * inv_var, labels, num_groups) * group_var
    return group_mu[labels], group_var.clamp(min=1e-6).log()[labels]


def group_wise_reparameterize(generator: torch.Generator | None, mu: torch.Tensor,
                              logvar: torch.Tensor, labels: torch.Tensor, num_groups: int,
                              train: bool = True, eps_std: float = 0.1) -> torch.Tensor:
    """One eps ~ N(0, eps_std) draw per group label, from ``generator``
    (reference utils.py:95-116); ``mu`` itself when not training."""
    if not train:
        return mu
    labels = torch.as_tensor(labels, device=mu.device).long()
    eps = eps_std * torch.randn((num_groups, logvar.shape[-1]), generator=generator,
                                device=mu.device, dtype=mu.dtype)
    return eps[labels] * (0.5 * logvar).exp() + mu


def permute_dims(generator: torch.Generator | None, z: torch.Tensor) -> torch.Tensor:
    """An independent batch permutation for each latent dim of (B, D) ``z``
    (utils.py:118-128)."""
    b, d = z.shape
    perms = torch.stack([torch.randperm(b, generator=generator, device=z.device)
                         for _ in range(d)], dim=1)                       # (B, D)
    return torch.gather(z, 0, perms)
