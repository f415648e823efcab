"""Feature-selection training on frozen-VAE latents (port of
dvc_tpu/train/feature_selection_trainer.py; reference
model/train_feature_selection.py:10-79, as dvc_tpu repaired it).

Encode every utterance with the trained, frozen VAE (eval mode), then train
the FeatureSelection MLP with Adam so that its sigmoid mask keeps the
speaker-discriminative latent dims.  Batches follow dvc_tpu's: a
``RandomState(0)`` permutation each epoch, partial batches dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from dvc_tpu_torch.models.feature_selection import FeatureSelection, feature_selection_loss
from dvc_tpu_torch.utils.device import resolve_device


def make_fs_step(model: FeatureSelection, optimizer: torch.optim.Optimizer) -> Callable:
    """Build step(latents, labels) -> (loss, acc), detached: the mask, the
    classifier on latents * mask, the reference's loss, one Adam update."""

    def step(latents: torch.Tensor, labels: torch.Tensor):
        mask = model(latents)
        pred = model.classify(latents * mask)
        loss = feature_selection_loss(pred, labels)
        acc = (pred.argmax(-1) == labels).float().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), acc

    return step


@dataclass
class FeatureSelectionTrainer:
    input_size: int
    num_spk: int
    lr: float = 1e-3
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # dvc_tpu draws its initial weights from PRNGKey(0)
        gen = torch.Generator().manual_seed(0)
        self.model = FeatureSelection(self.input_size, self.num_spk, gen).to(self.device)
        # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, torch's defaults
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr)
        self.step_fn = make_fs_step(self.model, self.optimizer)

    def encode_latents(self, vae_model: torch.nn.Module, mels: np.ndarray) -> np.ndarray:
        """Frozen-VAE latents [style_mu, content_mu] of (B, 80, T) mels, in
        eval mode (running BN statistics)."""
        dev = next(vae_model.parameters()).device
        was_training = vae_model.training
        vae_model.eval()
        try:
            with torch.no_grad():
                smu, _, cmu, _ = vae_model.encode(
                    torch.from_numpy(np.ascontiguousarray(mels, np.float32)).to(dev))
        finally:
            vae_model.train(was_training)
        return torch.cat([smu, cmu], -1).cpu().numpy()

    def train(self, latents: np.ndarray, labels: np.ndarray, epochs: int = 10,
              batch_size: int = 64, logging_func=print) -> dict:
        """``epochs`` passes in batches of min(batch_size, n); returns the
        last epoch's {"epoch", "loss", "acc"} (means over its batches)."""
        latents = torch.from_numpy(np.asarray(latents, np.float32)).to(self.device)
        labels = torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
        n = len(latents)
        batch_size = min(batch_size, n)
        if batch_size <= 0:
            raise ValueError("no latents to train on")
        rng = np.random.RandomState(0)
        last = {}
        for epoch in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            losses, accs = [], []
            for b in range(0, n - batch_size + 1, batch_size):
                idx = order[b:b + batch_size]
                loss, acc = self.step_fn(latents[idx], labels[idx])
                losses.append(float(loss))
                accs.append(float(acc))
            last = {"epoch": epoch, "loss": float(np.mean(losses)),
                    "acc": float(np.mean(accs))}
            logging_func(f"fs epoch {epoch}: loss {last['loss']:.4f} "
                         f"acc {last['acc']:.3f}")
        return last

    @torch.no_grad()
    def feature_mask(self, latents: np.ndarray) -> np.ndarray:
        """Mean sigmoid mask: which latent dims carry speaker identity."""
        x = torch.from_numpy(np.asarray(latents, np.float32)).to(self.device)
        return self.model(x).mean(0).cpu().numpy()
