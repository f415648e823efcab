"""GE2E speaker-encoder training (port of dvc_tpu/train/speaker_trainer.py).

Parity with reference preprocessing/encoder/train.py:18-133: a step-based
loop over (64 speakers x 10 utterances) batches; Adam(1e-4); the reference's
gradient ops (encoder/model.py:33-39) as dvc_tpu's optax chain does them:
the similarity weight's and bias's gradients times 0.01, then a clip to a
global norm of 3 (optax's rule: times 3 / norm only when the norm is above
3), then Adam (torch's, which is optax's with eps 1e-8).  One step is eager
on the device: cuDNN's LSTM and cuBLAS, float32 with TF32 off.  The state
is saved in dvc_tpu's GE2EState layout (``{run_id}.msgpack``, and
immutable backups ``{run_id}_bak_{step:06d}.msgpack``), which dvc_tpu's
``SpeakerEncoderTrainer.resume`` reads, and the port resumes dvc_tpu's.
The EER is computed on the host from the logged steps' similarity
matrices (eval/eer.py), never backpropagated.

``use_mesh`` (dvc_tpu's, speaker_trainer.py:76-148): when a process group
of more than one rank divides the speakers of a batch, every rank reads
the same batch and embeds its share of the speakers; the (S, U, E)
embeddings are all-gathered with their gradient, since the GE2E loss
couples every speaker through the centroids, and the gradients are
averaged over the ranks before the 0.01 scaling and the clip.  Otherwise
every rank runs the whole step.  Rank 0 alone saves.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from dvc_tpu_torch.config import MeshConfig, SpeakerEncoderConfig
from dvc_tpu_torch.eval.eer import ge2e_eer
from dvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from dvc_tpu_torch.parallel.collectives import all_gather, average_grads_
from dvc_tpu_torch.parallel.mesh import Mesh, data_rows, make_mesh, world_size
from dvc_tpu_torch.parallel.multihost import is_primary
from dvc_tpu_torch.train.checkpoint import _sorted_tree
from dvc_tpu_torch.train.trainer import make_optimizer
from dvc_tpu_torch.utils import msgpack
from dvc_tpu_torch.utils.convert import (optax_adam_from_torch, speaker_encoder_state_dict_from_jax,
                                         speaker_encoder_tree_from_state_dict,
                                         torch_adam_from_optax)
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32

SIMILARITY_GRAD_SCALE = 0.01  # encoder/model.py:33-36
CLIP_NORM = 3.0               # encoder/model.py:39


def create_speaker_encoder(cfg: SpeakerEncoderConfig, seed: int = 0,
                           device: str | torch.device = "cuda") -> SpeakerEncoder:
    """A fresh encoder on ``device`` in train mode, its weights drawn from
    ``seed`` (the global torch RNG is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SpeakerEncoder(cfg)
    return model.to(resolve_device(device)).train()


@torch.no_grad()
def scale_and_clip_grads_(model: SpeakerEncoder, scale: float = SIMILARITY_GRAD_SCALE,
                          max_norm: float = CLIP_NORM) -> None:
    """The optax chain ahead of Adam, on ``.grad`` in place: the two
    similarity gradients times ``scale``, then every gradient clipped as
    ``optax.clip_by_global_norm`` does, g / norm * max_norm where the
    global norm is at least max_norm (torch's clip_grad_norm_ divides by
    norm + 1e-6 instead).  No host sync."""
    model.similarity_weight.grad.mul_(scale)
    model.similarity_bias.grad.mul_(scale)
    grads = [p.grad for p in model.parameters()]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_ge2e_step(model: SpeakerEncoder, optimizer: torch.optim.Optimizer,
                   mesh: Mesh | None = None) -> Callable:
    """Build step(batch, with_sim=True) -> (loss, sim) or loss, detached.

    batch is (S, U, T, n_mels); sim the (S*U, S) similarity matrix, which
    only the logging steps need.  After a step each parameter's ``.grad``
    holds what Adam was given (scaled and clipped).  With a ``mesh`` every
    rank passes the same batch and embeds its rows of the speakers on the
    data axis (see the module docstring)."""

    def step(batch: torch.Tensor, with_sim: bool = True):
        if mesh is not None:
            batch = batch[data_rows(batch.shape[0], mesh)]
        s, u, t, m = batch.shape
        embeds = model(batch.reshape(s * u, t, m)).reshape(s, u, -1)
        if mesh is not None:
            embeds = all_gather(embeds, 0, mesh.data_group)
        loss, sim = model.loss(embeds)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            average_grads_(model.parameters(), mesh.data_group)
        scale_and_clip_grads_(model)
        optimizer.step()
        return (loss.detach(), sim.detach()) if with_sim else loss.detach()

    return step


def ge2e_state_tree(model: SpeakerEncoder, optimizer: torch.optim.Optimizer,
                    step: int) -> dict:
    """The encoder and its Adam as dvc_tpu's GE2EState state dict: step,
    params, and the optax chain's state (scale-similarity and clip
    EmptyStates, then adam's (ScaleByAdamState, EmptyState)), every dict
    sorted as a trained state's are."""
    params = speaker_encoder_tree_from_state_dict(model.state_dict())
    adam = optax_adam_from_torch(model, optimizer, speaker_encoder_tree_from_state_dict)
    return {"step": np.array(step, np.int32), "params": _sorted_tree(params),
            "opt_state": _sorted_tree({"0": {}, "1": {}, "2": adam})}


def load_ge2e_state(tree: dict, model: SpeakerEncoder,
                    optimizer: torch.optim.Optimizer) -> int:
    """Load a GE2EState tree (either package's) into ``model`` and
    ``optimizer``; returns its step."""
    missing = {"step", "params", "opt_state"} - set(tree)
    if missing:
        raise ValueError(f"not a GE2EState checkpoint (no {sorted(missing)})")
    model.load_state_dict(speaker_encoder_state_dict_from_jax(tree["params"]))
    torch_adam_from_optax(model, optimizer, tree["opt_state"]["2"],
                          speaker_encoder_state_dict_from_jax)
    return int(np.asarray(tree["step"]))


@dataclass
class SpeakerEncoderTrainer:
    cfg: SpeakerEncoderConfig
    run_id: str = "ge2e"
    models_dir: str = ""
    # data-parallel over the ranks when they divide the speakers of a batch
    use_mesh: bool = True
    device: str | torch.device = "cuda"
    step: int = field(default=0, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        use_exact_float32()
        self.model = create_speaker_encoder(self.cfg, 0, self.device)
        self.optimizer = make_optimizer(self.model, self.cfg.learning_rate)
        self.mesh = None
        n = world_size()
        if self.use_mesh and n > 1 and self.cfg.speakers_per_batch % n == 0:
            self.mesh = make_mesh(MeshConfig(data_parallel=n, model_parallel=1), self.device)
        self.step_fn = make_ge2e_step(self.model, self.optimizer, self.mesh)

    # -- persistence ({step, model_state, optimizer_state}, train.py:47-54) --

    @property
    def _state_path(self) -> str:
        return os.path.join(self.models_dir, f"{self.run_id}.msgpack")

    def save(self, backup: bool = False) -> None:
        """Write the state (rank 0 alone: every rank holds the same)."""
        if not is_primary():
            return
        os.makedirs(self.models_dir, exist_ok=True)
        data = msgpack.packb(ge2e_state_tree(self.model, self.optimizer, self.step))
        paths = [self._state_path]
        if backup:
            paths.append(os.path.join(self.models_dir,
                                      f"{self.run_id}_bak_{self.step:06d}.msgpack"))
        for path in paths:  # whole files only: a reader never sees a partial one
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)

    def resume(self) -> bool:
        if not os.path.exists(self._state_path):
            return False
        with open(self._state_path, "rb") as f:
            self.step = load_ge2e_state(msgpack.unpackb(f.read()), self.model, self.optimizer)
        return True

    # -- loop ---------------------------------------------------------------

    def train(self, sampler, n_steps: int, save_every: int = 500,
              backup_every: int = 3000, log_every: int = 10,
              vis=None, projection_every: int = 0,
              logging_func=print) -> list[dict]:
        """``sampler`` yields (S, U, T, n_mels) batches (numpy, or tensors
        already on the device from DeviceResidentSampler).  Every
        ``log_every`` steps the loss and the batch's EER are logged; ``vis``
        (utils.visualizations.Visualizations) streams the curves and, every
        ``projection_every`` steps, an embedding projection PNG (the
        reference's visdom + UMAP loop, encoder/train.py:102-111)."""
        from dvc_tpu_torch.data.dataset import prefetch

        def device_batches():
            for b in sampler:
                yield torch.as_tensor(b).to(self.device, non_blocking=True)

        self.model.train()
        history = []
        t_last = time.time()
        it = prefetch(device_batches(), depth=2)
        for _ in range(n_steps):
            batch = next(it)
            log_this = (self.step + 1) % log_every == 0
            out = self.step_fn(batch, with_sim=log_this)
            self.step += 1
            if log_this:
                loss, sim = out
                loss_f = loss.item()
                eer = ge2e_eer(sim.cpu().numpy(), batch.shape[0], batch.shape[1])
                dt = (time.time() - t_last) / log_every
                t_last = time.time()
                history.append({"step": self.step, "loss": loss_f, "eer": eer,
                                "step_time_s": dt})
                logging_func(f"step {self.step}: loss {loss_f:.4f} EER {eer:.4f} "
                             f"({dt * 1000:.0f} ms/step)")
                if vis is not None:
                    vis.update(loss_f, eer, dt, self.step)
            if vis is not None and projection_every and self.step % projection_every == 0:
                with torch.no_grad():
                    embeds = self.model(batch.reshape(-1, *batch.shape[-2:]))
                vis.draw_projections(embeds.cpu().numpy(), batch.shape[1], self.step)
            if self.models_dir and save_every and self.step % save_every == 0:
                self.save()
            if self.models_dir and backup_every and self.step % backup_every == 0:
                self.save(backup=True)
        if vis is not None:
            vis.save()
        return history
