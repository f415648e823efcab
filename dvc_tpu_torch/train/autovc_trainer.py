"""AutoVC baseline training step (port of dvc_tpu/train/autovc_trainer.py).

The reference ships the AutoVC models (autovc_replicate/) but no trainer;
dvc_tpu's step is the standard AutoVC objective (Qian et al. 2019):

    L = mse(x, x̂) + mse(x, x̂_post) + λ mean|C(x) - C(x̂_post)|

with λ = 1 and Adam.  C(x̂_post) re-encodes the postnet output in eval mode
with the running statistics that the same train forward has just updated;
dvc_tpu differentiates through those statistics into the encoder's
convolutions, and so does this step (models/layers.running_stats_in_graph).
One step is eager on the device, float32 with TF32 off.  The state is
dvc_tpu's AutoVCState (step, params, batch_stats, opt_state), which
``train-autovc`` writes as ``autovc_{epoch}.msgpack``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from dvc_tpu_torch.config import AutoVCConfig
from dvc_tpu_torch.models.autovc import AutoVC
from dvc_tpu_torch.models.layers import BatchNorm, running_stats_in_graph
from dvc_tpu_torch.train.checkpoint import _sorted_tree
from dvc_tpu_torch.train.trainer import make_optimizer
from dvc_tpu_torch.utils.convert import (autovc_state_dict_from_jax, autovc_tree_from_state_dict,
                                         optax_adam_from_torch, torch_adam_from_optax)
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32


class AutoVCTerms(NamedTuple):
    total: torch.Tensor
    recon: torch.Tensor        # mse(x, mel)
    recon_post: torch.Tensor   # mse(x, mel_postnet)
    content: torch.Tensor      # mean |codes - C(mel_postnet)|


def create_autovc(cfg: AutoVCConfig = AutoVCConfig(), lr: float = 1e-4, seed: int = 0,
                  device: str | torch.device = "cuda"
                  ) -> tuple[AutoVC, torch.optim.Adam]:
    """A fresh AutoVC in train mode on ``device``, its weights drawn from
    ``seed`` (the global torch RNG is left as it was), and its Adam."""
    dev = resolve_device(device)
    use_exact_float32()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = AutoVC(cfg)
    model = model.to(dev).train()
    return model, make_optimizer(model, lr)


def make_autovc_step(model: AutoVC, optimizer: torch.optim.Optimizer,
                     lambda_content: float = 1.0) -> Callable:
    """Build step(x (B, T, n_mels), emb (B, dim_emb)) -> AutoVCTerms
    (detached).  The model must be in train mode; after the step its
    BatchNorm running statistics have moved once, as dvc_tpu's
    ``mut["batch_stats"]``, and each ``.grad`` holds the applied gradient."""

    # dvc_tpu re-encodes with train=False, which only its BatchNorms read:
    # the LSTMs have no dropout, and cuDNN differentiates an RNN only when
    # it ran in training mode, so only the BatchNorms switch to eval
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def step(x: torch.Tensor, emb: torch.Tensor) -> AutoVCTerms:
        with running_stats_in_graph(model):
            mel, mel_post, codes = model(x, emb, emb)
            for m in norms:
                m.eval()
            try:
                codes_recon = model(mel_post, emb, None)
            finally:
                for m in norms:
                    m.train()
        l_recon = (x - mel).square().mean()
        l_recon0 = (x - mel_post).square().mean()
        l_content = (codes - codes_recon).abs().mean()
        total = l_recon + l_recon0 + lambda_content * l_content
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return AutoVCTerms(total.detach(), l_recon.detach(), l_recon0.detach(),
                           l_content.detach())

    return step


def autovc_state_tree(model: AutoVC, optimizer: torch.optim.Optimizer, step: int) -> dict:
    """The model and its Adam as dvc_tpu's AutoVCState state dict, every
    dict sorted as a trained state's are."""
    params, stats = autovc_tree_from_state_dict(model.state_dict())
    adam = optax_adam_from_torch(model, optimizer, lambda sd: autovc_tree_from_state_dict(sd)[0])
    return {"step": np.array(step, np.int32), "params": _sorted_tree(params),
            "batch_stats": _sorted_tree(stats), "opt_state": _sorted_tree(adam)}


def load_autovc_state(tree: dict, model: torch.nn.Module,
                      optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load an AutoVCState tree (either package's) into ``model`` (and its
    Adam state into ``optimizer``); returns its step."""
    missing = {"step", "params", "batch_stats", "opt_state"} - set(tree)
    if missing:
        raise ValueError(f"not an AutoVCState checkpoint (no {sorted(missing)})")
    model.load_state_dict(autovc_state_dict_from_jax(tree["params"], tree["batch_stats"]))
    if optimizer is not None:
        torch_adam_from_optax(model, optimizer, tree["opt_state"],
                              lambda t: autovc_state_dict_from_jax(t, None))
    return int(np.asarray(tree["step"]))
