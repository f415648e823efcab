"""Adversarial content regularization of the disentangled VAE (port of
dvc_tpu/train/adversarial.py).

A speaker classifier on the CONTENT posterior means of both utterances of a
pair; ``LossConfig.adv_cof`` > 0 adds its term to the VAE's loss, and one
backward pass of the combined loss trains both nets.  Two modes:

- ``"confusion"`` (the default): the content means are z-scored over the
  batch (population std, as ``jnp.std``), so shrinking the latent cannot
  lower the term; the classifier learns on detached latents, and the
  encoder minimises the cross-entropy against the uniform distribution
  through the classifier with its parameters detached.
- ``"grl"``: one cross-entropy, the encoder's gradient sign-flipped by
  ``grad_reverse``.

The adversary's weights and Adam state live outside the VAE checkpoint, so
the ``.pth``, ``.opt.pth`` and ``.msgpack`` files keep their layout; after
a resume it starts again from its seed.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.nn.utils import skip_init

from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.layers import flax_init_
from dvc_tpu_torch.parallel.collectives import all_reduce_sum, group_size
from dvc_tpu_torch.train.losses import LossTerms, gvae_pair_loss
from dvc_tpu_torch.train.trainer import make_pair_forward

class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def grad_reverse(x: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """Identity forward; the backward multiplies the gradient by -lam
    (Ganin & Lempitsky 2015)."""
    return _GradReverse.apply(x, lam)


class SpeakerAdversary(nn.Module):
    """Dense(hidden) -> relu -> Dense(hidden) -> relu -> Dense(n_speakers)
    over the content latent, with flax's Dense init drawn from
    ``generator``."""

    def __init__(self, content_size: int, n_speakers: int, hidden: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc0 = skip_init(nn.Linear, content_size, hidden)
        self.fc1 = skip_init(nn.Linear, hidden, hidden)
        self.out = skip_init(nn.Linear, hidden, n_speakers)
        flax_init_(self, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(self.fc1(F.relu(self.fc0(z)))))


def zscore(z: torch.Tensor, group=None) -> torch.Tensor:
    """Per-dim z-score over the batch, with the population std (ddof 0).
    With a process group of more than one rank (the data axis of a mesh,
    each rank holding its rows) the mean and std are the global batch's,
    as dvc_tpu's over its sharded batch, and differentiable through it."""
    if group_size(group) == 1:
        return (z - z.mean(0, keepdim=True)) / (z.std(0, keepdim=True, correction=0) + 1e-5)
    n = z.shape[0] * group_size(group)
    d = z - all_reduce_sum(z.sum(0, keepdim=True), group) / n
    std = (all_reduce_sum(d.square().sum(0, keepdim=True), group) / n).sqrt()
    return d / (std + 1e-5)


def make_adv_train_step(model: DisentangledVAE, optimizer: torch.optim.Optimizer,
                        adversary: SpeakerAdversary, adv_optimizer: torch.optim.Optimizer,
                        mse_cof: float = 10.0, kl_cof: float = 10.0, adv_cof: float = 10.0,
                        mode: str = "confusion", compute_dtype: str = "float32",
                        remat: bool = False, data_group=None) -> Callable:
    """Build step(x1, x2, spk, generator=None, eps=None) ->
    (LossTerms, {"adv_ce", "adv_acc"}), all detached.

    The contract of trainer.make_train_step plus the speaker ids (B,) and
    the adversary: one backward of ``terms.total + adv_cof * adv_term``,
    then an Adam update of each net.  ``data_group``: the mesh's data axis,
    over which the confusion mode's z-score spans the global batch."""
    if mode not in ("confusion", "grl"):
        raise ValueError(f"mode must be 'confusion' or 'grl', got {mode!r}")
    forward = make_pair_forward(model, compute_dtype, remat)
    s = model.cfg.speaker_size

    def step(x1: torch.Tensor, x2: torch.Tensor, spk: torch.Tensor,
             generator: torch.Generator | None = None, eps=None):
        outs = forward(x1, x2, generator, eps)
        terms = gvae_pair_loss(x1, x2, *outs, mse_cof=mse_cof, kl_cof=kl_cof)
        # the content posterior means of both utterances of the pair
        # (q_z*_mu = concat[style_mu, content_mu])
        zc = torch.cat([outs[4][:, s:], outs[6][:, s:]], 0)
        labels = torch.cat([spk, spk], 0).long()
        if mode == "grl":
            logits = adversary(grad_reverse(zc, 1.0))
            ce = F.cross_entropy(logits, labels)
            adv_term = ce
        else:
            zc = zscore(zc, data_group)
            logits = adversary(zc.detach())  # the classifier learns the speaker
            ce = F.cross_entropy(logits, labels)
            # the encoder: classifier frozen, target uniform, -mean(log p)
            frozen = {n: p.detach() for n, p in adversary.named_parameters()}
            logits_enc = functional_call(adversary, frozen, (zc,))
            adv_term = ce - F.log_softmax(logits_enc, dim=-1).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        optimizer.zero_grad(set_to_none=True)
        adv_optimizer.zero_grad(set_to_none=True)
        (terms.total + adv_cof * adv_term).backward()
        optimizer.step()
        adv_optimizer.step()
        return (LossTerms(*(t.detach() for t in terms)),
                {"adv_ce": ce.detach(), "adv_acc": acc})

    return step
