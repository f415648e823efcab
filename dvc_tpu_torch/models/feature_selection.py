"""Speaker-discriminative latent-dimension selector (port of
dvc_tpu/models/feature_selection.py; reference model/feature_selection.py:5-43).

An MLP that gives a sigmoid mask over the latent dims, and a speaker
classifier of the masked latents, trained with cross-entropy on the frozen
VAE's latents (train/feature_selection_trainer.py) to find which dims carry
speaker identity.  Every layer starts as flax's ``nn.Dense`` does
(lecun-normal kernel, zero bias), drawn from an explicit generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from dvc_tpu_torch.models.layers import flax_init_

HIDDEN = 1024


class FeatureSelection(nn.Module):
    """``forward``: latents (B, D) -> sigmoid feature mask (B, D);
    ``classify``: masked latents -> speaker probabilities (softmaxed, as
    the reference's classify is)."""

    def __init__(self, input_size: int, num_spk: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ln1 = skip_init(nn.Linear, input_size, HIDDEN)
        self.ln2 = skip_init(nn.Linear, HIDDEN, HIDDEN)
        self.weight = skip_init(nn.Linear, HIDDEN, input_size)
        self.cls_linear = skip_init(nn.Linear, input_size, HIDDEN)
        self.prediction = skip_init(nn.Linear, HIDDEN, num_spk)
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.ln1(x))
        out = F.relu(self.ln2(out))
        return torch.sigmoid(self.weight(out))

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.prediction(F.relu(self.cls_linear(x))), dim=-1)


def feature_selection_loss(prediction: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The reference's loss: cross-entropy applied to the ALREADY softmaxed
    predictions, i.e. the mean NLL of log_softmax(softmax(logits)).  Kept
    as it is: plain cross-entropy would train another mask."""
    logprob = F.log_softmax(prediction, dim=-1)
    return -logprob.gather(1, label[:, None].long()).mean()
