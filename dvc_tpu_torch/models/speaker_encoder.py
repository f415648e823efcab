"""GE2E speaker encoder (port of dvc_tpu/models/speaker_encoder.py).

Parity with reference preprocessing/encoder/model.py:12-138: a 3-layer
LSTM(80 -> 256) whose last layer's final hidden state goes through Linear ->
ReLU -> L2 normalize (embedding 256); the GE2E similarity matrix with
inclusive/exclusive centroids scaled by learned (weight 10, bias -5); a
softmax loss over speakers.  The LSTM is ``nn.LSTM`` (cuDNN on the card),
whose gate order and weight layout are dvc_tpu's; the Linear has flax's
Dense init.  The similarity matrix is masked einsums, as in dvc_tpu, not
the reference's per-speaker loop (encoder/model.py:89-92).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dvc_tpu_torch.config import SpeakerEncoderConfig
from dvc_tpu_torch.models.layers import flax_init_


def safe_l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / ||x|| with a finite forward and backward at x == 0: x times the
    rsqrt of the epsilon-shifted sum of squares (dvc_tpu's
    _safe_l2_normalize).  ``F.normalize`` clamps the norm instead, which
    gives another gradient near 0."""
    return x * torch.rsqrt(x.square().sum(dim=dim, keepdim=True) + 1e-24)


class SpeakerEncoder(nn.Module):
    """(B, n_frames, n_mels) -> L2-normalized embeddings (B, E).  Built
    with torch's LSTM init (dvc_tpu's, U(+-1/sqrt(hidden))) and flax's
    Dense init for the Linear; draws from the global torch RNG."""

    def __init__(self, cfg: SpeakerEncoderConfig = SpeakerEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(cfg.mel_n_channels, cfg.hidden_size, cfg.num_layers,
                            batch_first=True)
        self.linear = flax_init_(nn.Linear(cfg.hidden_size, cfg.embedding_size))
        self.similarity_weight = nn.Parameter(torch.full((1,), 10.0))
        self.similarity_bias = nn.Parameter(torch.full((1,), -5.0))

    def forward(self, utterances: torch.Tensor) -> torch.Tensor:
        _, (h, _) = self.lstm(utterances)
        return safe_l2_normalize(F.relu(self.linear(h[-1])), dim=1)

    def similarity_matrix(self, embeds: torch.Tensor) -> torch.Tensor:
        """(S, U, E) -> (S, U, S) GE2E similarities (encoder/model.py:63-105):
        each embedding against every speaker's inclusive centroid, and
        against its own speaker's exclusive centroid (the diagonal, picked
        by an eye mask).  The centroids are normalized safely."""
        s, u, _ = embeds.shape
        incl = safe_l2_normalize(embeds.mean(dim=1, keepdim=True), dim=2)     # (S, 1, E)
        excl = safe_l2_normalize((embeds.sum(dim=1, keepdim=True) - embeds) / (u - 1),
                                 dim=2)                                       # (S, U, E)
        sim_incl = torch.einsum("sue,je->suj", embeds, incl[:, 0, :])
        sim_excl = (embeds * excl).sum(dim=2)
        eye = torch.eye(s, dtype=torch.bool, device=embeds.device)[:, None, :]
        sim = torch.where(eye, sim_excl[:, :, None], sim_incl)
        return sim * self.similarity_weight + self.similarity_bias

    def loss(self, embeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """GE2E softmax loss (encoder/model.py:107-123) of (S, U, E)
        embeddings -> (scalar loss, the (S*U, S) similarity matrix)."""
        s, u, _ = embeds.shape
        sim = self.similarity_matrix(embeds).reshape(s * u, s)
        target = torch.arange(s, device=embeds.device).repeat_interleave(u)
        return F.cross_entropy(sim, target), sim
