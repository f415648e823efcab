"""Training runtime of the disentangled VAE (port of dvc_tpu/train/trainer.py:50-453).

One train step is forward(pair) + loss + backward + Adam, eager on the
device: cuDNN convolutions and LSTMs, cuBLAS matmuls, in exact float32
(TF32 off, as the serving path).  Epoch and checkpoint semantics follow
run_training (reference model/variational_base_vae.py:156-203): an
epoch-indexed loop, per-epoch re-pairing of utterances, TensorBoard scalars
with the reference's names, a checkpoint every ``report_interval`` epochs
named ``DisentangledVAE_VCTK_{epoch}``, and resume from the newest one;
with ``estimation_dir``, original and reconstructed mel PNGs after each
save.

``compute_dtype="bfloat16"`` (the default) rounds the two input batches to
bf16 and computes in float32, as dvc_tpu does: its model is built with no
dtype, so every flax layer promotes the bf16 input with its float32
parameters back to float32 (dvc_tpu/train/trainer.py:53,81-87).  The loss
is taken against the unrounded inputs.

While a torch.profiler records, an epoch records spans
(utils/profiling.py): each batch's ``train.data_wait`` (data/dataset.py's
``prefetch``), ``train.h2d``, ``train.forward`` (forward and loss),
``train.backward`` (``zero_grad`` and the backward) and
``train.optimizer``, then one ``train.epoch_tail`` (the re-pairing and the
loss totals' read-back).

``TrainConfig.remat`` recomputes the pair forward in the backward pass
(``torch.utils.checkpoint`` over the region dvc_tpu wraps in
``jax.checkpoint``); ``LossConfig.adv_cof`` > 0 trains the speaker
adversary of train/adversarial.py beside the VAE.

The mesh (``Trainer.use_mesh``, the default, as in dvc_tpu): with a
process group (torchrun, parallel.multihost.initialize_distributed) the
Trainer lays a ``MeshConfig`` mesh over the ranks, dp reduced to the
largest divisor of the batch, as dvc_tpu does, that leaves the world a
whole number of meshes (``trainer_dp``).  Each rank walks the same
seeded pairing and keeps its rows of every batch; the BatchNorms take
their statistics over the global batch; each rank draws the global
batch's noise from the step's seed and keeps its rows; the weights that
``param_sharding_for`` shards compute column-parallel over the model
axis; ``parallel.tensor.MeshAdam`` averages the gradients and, with
``MeshConfig.shard_opt_state``, keeps Adam's moments in ZeRO shards; the
logged terms are averaged over the data axis.  With
``checkpoint_format="orbax"`` every rank writes the chunks it holds into
its own store of the checkpoint and rank 0 its metadata
(``checkpoint.save_orbax_sharded``, no gather); with msgpack rank 0
writes the files one process writes, gathered from the shards.  Rank 0
alone writes TensorBoard and the PNGs; every rank resumes from the same
files, reading whole arrays and keeping its blocks.  With
no process group the step is the one-process step, unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from dvc_tpu_torch.config import Config
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.layers import frozen_running_stats
from dvc_tpu_torch.parallel.mesh import (Mesh, data_rows, has_process_group, make_mesh,
                                         mesh_shape, shard_batch, train_state_shardings,
                                         world_size)
from dvc_tpu_torch.parallel.multihost import is_primary
from dvc_tpu_torch.parallel.tensor import MeshAdam, gather_full_, scatter_full_, shard_model_
from dvc_tpu_torch.train import checkpoint as ckpt_lib
from dvc_tpu_torch.train.losses import LossTerms, gvae_pair_loss
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32
from dvc_tpu_torch.utils.profiling import span

NOT_PORTED = "not yet ported — see ROADMAP.md"


def unported_settings(cfg: Config) -> list[str]:
    """The settings of ``cfg`` the port does not train with yet."""
    out = []
    if cfg.train.compute_dtype not in ("bfloat16", "float32"):
        out.append(f"compute_dtype={cfg.train.compute_dtype!r}")
    return out


def create_model(cfg: Config, device: str | torch.device = "cuda") -> DisentangledVAE:
    """The VAE in train mode on ``device``, its weights drawn from
    ``cfg.train.seed`` (the global torch RNG is left as it was)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = DisentangledVAE(cfg.vae, pair_fused=cfg.vae.pair_fused)
    return model.to(dev).train()


def make_optimizer(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    # torch.optim.Adam defaults (reference model/disentangled_vae.py:304),
    # which is dvc_tpu's optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def draw_eps(model: DisentangledVAE, batch: int, generator: torch.Generator | None,
             device: torch.device) -> tuple[torch.Tensor, ...]:
    """The train forward's standard-normal draws, content1, content2 and
    style, drawn as the forward draws them: the same values it would draw
    from ``generator`` (the global RNG when None)."""
    c = model.cfg
    return tuple(torch.randn((batch, n), generator=generator, device=device)
                 for n in (c.content_size, c.content_size, c.speaker_size))


def make_pair_forward(model: DisentangledVAE, compute_dtype: str = "float32",
                      remat: bool = False) -> Callable:
    """Build forward(x1, x2, generator=None, eps=None) -> the ten outputs of
    the pairwise train forward, on inputs rounded to bf16 when
    ``compute_dtype`` is "bfloat16".

    ``remat``: the forward runs under a non-reentrant
    ``torch.utils.checkpoint`` and is recomputed in the backward pass.  The
    noise is drawn before the checkpointed region and passed in (checkpoint
    restores the global RNGs, not a ``torch.Generator``), and the
    recomputation leaves the BatchNorm running statistics alone, so they
    move once a step, as with dvc_tpu's pure ``jax.checkpoint``."""
    round_bf16 = compute_dtype == "bfloat16"

    def recompute_context():
        return contextlib.nullcontext(), frozen_running_stats(model)

    def forward(x1: torch.Tensor, x2: torch.Tensor,
                generator: torch.Generator | None = None, eps=None):
        if round_bf16:
            x1 = x1.to(torch.bfloat16).to(torch.float32)
            x2 = x2.to(torch.bfloat16).to(torch.float32)
        if not remat:
            return model(x1, x2, generator=generator, eps=eps)
        if eps is None:
            eps = draw_eps(model, x1.shape[0], generator, x1.device)
        # the eps drawn here are the only randomness of the region
        return checkpoint(lambda a, b, e: model(a, b, eps=e), x1, x2, tuple(eps),
                          use_reentrant=False, preserve_rng_state=False,
                          context_fn=recompute_context)

    return forward


def make_train_step(model: DisentangledVAE, optimizer: torch.optim.Optimizer,
                    mse_cof: float = 10.0, kl_cof: float = 10.0,
                    compute_dtype: str = "float32", remat: bool = False) -> Callable:
    """Build step(x1, x2, generator=None, eps=None) -> LossTerms (detached).

    The model must be in train mode.  After a step each parameter's
    ``.grad`` holds the gradient the optimizer applied; the BatchNorm
    running statistics have moved as dvc_tpu's ``mutable=["batch_stats"]``
    returns them.  ``remat``: see make_pair_forward."""
    forward = make_pair_forward(model, compute_dtype, remat)

    def step(x1: torch.Tensor, x2: torch.Tensor,
             generator: torch.Generator | None = None, eps=None) -> LossTerms:
        with span("train.forward"):
            outs = forward(x1, x2, generator, eps)
            terms = gvae_pair_loss(x1, x2, *outs, mse_cof=mse_cof, kl_cof=kl_cof)
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            terms.total.backward()
        with span("train.optimizer"):
            optimizer.step()
        return LossTerms(*(t.detach() for t in terms))

    return step


@torch.no_grad()
def eval_terms(model: DisentangledVAE, x1: torch.Tensor, x2: torch.Tensor,
               generator: torch.Generator, mse_cof: float = 10.0,
               kl_cof: float = 10.0) -> LossTerms:
    """Eval-mode step (reference test(), model/variational_base_vae.py:105-123):
    running BN statistics, the content posteriors' means; z_style is still
    sampled (reference quirk, model/disentangled_vae.py:261), from
    ``generator``."""
    was_training = model.training
    model.eval()
    try:
        outs = model(x1, x2, generator=generator)
    finally:
        model.train(was_training)
    return gvae_pair_loss(x1, x2, *outs, mse_cof=mse_cof, kl_cof=kl_cof)


def trainer_dp(cfg: Config, world: int) -> int:
    """The data axis of dvc_tpu's Trainer mesh over ``world`` ranks:
    ``cfg.mesh``'s, reduced to the largest value that divides the batch
    (batch 2 on 4 ranks: dp 2) and leaves the world a whole number of
    dp x mp meshes (3 ranks at batch 8: dp 1, three replicas), so small
    batches and odd card counts train anywhere."""
    dp, mp = mesh_shape(cfg.mesh, world)
    b = cfg.train.batch_size
    while dp > 1 and (b % dp or world % (dp * mp)):
        dp -= 1
    return dp


def trainer_mesh(cfg: Config, device: str | torch.device = "cuda") -> Mesh:
    """dvc_tpu's Trainer mesh: ``cfg.mesh`` over every rank, its data axis
    by ``trainer_dp``."""
    dp = trainer_dp(cfg, world_size())
    return make_mesh(dataclasses.replace(cfg.mesh, data_parallel=dp), device)


def _step_seed(seed: int, step: int) -> int:
    """The noise seed of one train step, a function of (seed, step) only, as
    dvc_tpu folds the step into its key: a resumed run draws what an
    uninterrupted one would."""
    return (seed * 1_000_003 + step) % (2 ** 63)


@dataclass
class Trainer:
    """Host-side training loop (mirrors run_training,
    model/variational_base_vae.py:156-203)."""

    cfg: Config
    checkpoints_path: str = ""
    logs_path: str = ""
    estimation_dir: str = ""
    run_name: str = ckpt_lib.RUN_NAME
    use_mesh: bool = True
    device: str | torch.device = "cuda"
    step: int = field(default=0, init=False)

    def __post_init__(self):
        bad = unported_settings(self.cfg)
        if bad:
            raise NotImplementedError(f"{', '.join(bad)}: {NOT_PORTED}")
        self.device = resolve_device(self.device)
        use_exact_float32()  # float32 training, never TF32
        train, loss = self.cfg.train, self.cfg.loss
        # the mesh needs a process group; one process trains as it always has
        self.mesh = (trainer_mesh(self.cfg, self.device)
                     if self.use_mesh and has_process_group() else None)
        self.model = create_model(self.cfg, self.device)
        if self.mesh is None:
            self.optimizer = make_optimizer(self.model, train.learning_rate)
        else:
            self.shardings = train_state_shardings(self.model, self.mesh.shape,
                                                   self.cfg.mesh.shard_opt_state)
            shard_model_(self.model, self.mesh, self.shardings["params"])
            self.optimizer = MeshAdam(self.model.named_parameters(), self.mesh,
                                      train.learning_rate, self.shardings["params"],
                                      self.shardings["opt_state"])
        # the adversary (adv_cof > 0) lives beside the VAE, outside its
        # checkpoints; after a resume it starts again from its seed
        self.adversary = self.adv_optimizer = None
        self.adv_metrics: dict[str, torch.Tensor] = {}  # the last step's
        if loss.adv_cof > 0:
            if loss.adv_speakers <= 0:
                raise ValueError("LossConfig.adv_cof > 0 requires "
                                 "adv_speakers (the corpus speaker count)")
            from dvc_tpu_torch.train.adversarial import SpeakerAdversary, make_adv_train_step
            self.adversary = SpeakerAdversary(
                self.cfg.vae.content_size, loss.adv_speakers,
                generator=torch.Generator().manual_seed(train.seed + 2)).to(self.device)
            # dvc_tpu replicates the adversary's state over the mesh
            self.adv_optimizer = (
                make_optimizer(self.adversary, loss.adv_lr) if self.mesh is None
                else MeshAdam(self.adversary.named_parameters(), self.mesh, loss.adv_lr))
            self.train_step = make_adv_train_step(
                self.model, self.optimizer, self.adversary, self.adv_optimizer,
                mse_cof=loss.mse_cof, kl_cof=loss.kl_cof, adv_cof=loss.adv_cof,
                mode=loss.adv_mode, compute_dtype=train.compute_dtype, remat=train.remat,
                data_group=None if self.mesh is None else self.mesh.data_group)
        else:
            self.train_step = make_train_step(
                self.model, self.optimizer, mse_cof=loss.mse_cof, kl_cof=loss.kl_cof,
                compute_dtype=train.compute_dtype, remat=train.remat)
        self._gen = torch.Generator(device=self.device)
        self._writer = None
        self._clamp_logged = False

    # -- checkpointing (latest-wins by epoch parsed from the filename) ------

    def load_last(self, require: bool = False) -> int:
        """Resume from the newest checkpoint (weights, BN statistics, Adam
        state and step); returns the next epoch (1 when none is found).
        require=True raises instead."""
        loaded = None
        if self.checkpoints_path and self.mesh is None:
            loaded = ckpt_lib.load_train_state(self.checkpoints_path, self.model,
                                               self.optimizer, self.run_name)
        elif self.checkpoints_path:
            # every rank reads the whole state and keeps its shards
            full, full_opt = self._full_template()
            loaded = ckpt_lib.load_train_state(self.checkpoints_path, full, full_opt,
                                               self.run_name)
            if loaded is not None:
                scatter_full_(self.model, self.optimizer, full, full_opt)
        if loaded is None:
            if require:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.checkpoints_path!r} — "
                    "train first, or check --log_dir")
            return 1
        epoch, self.step = loaded
        return epoch + 1

    def save(self, epoch: int) -> str:
        """Write the epoch's checkpoint; returns the .pth's path (the
        .orbax directory's for a mesh's orbax save).  Under a mesh, orbax:
        every rank writes its own chunks (``save_orbax_sharded``); msgpack:
        every rank gathers the shards and rank 0 writes the files one
        process writes.  No rank returns before they are whole."""
        fmt = self.cfg.train.checkpoint_format
        if self.mesh is None:
            return ckpt_lib.save_checkpoint(self.checkpoints_path, self.run_name, epoch,
                                            self.model, self.optimizer, self.step, fmt=fmt)
        if fmt == "orbax":
            return ckpt_lib.save_orbax_sharded(self.checkpoints_path, self.run_name, epoch,
                                               self.model, self.optimizer, self.step)
        full, full_opt = self._full_template()
        gather_full_(full, full_opt, self.model, self.optimizer)
        path = os.path.join(self.checkpoints_path, f"{self.run_name}_{epoch}{ckpt_lib.SUFFIX}")
        if is_primary():
            path = ckpt_lib.save_checkpoint(self.checkpoints_path, self.run_name, epoch,
                                            full, full_opt, self.step, fmt=fmt)
        dist.barrier()
        return path

    def _full_template(self) -> tuple[DisentangledVAE, torch.optim.Adam]:
        """An unsharded VAE and its Adam on the CPU, for the checkpoints."""
        full = create_model(self.cfg, "cpu")
        return full, make_optimizer(full, self.cfg.train.learning_rate)

    # -- steps ----------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device, non_blocking=True)

    def step_on(self, x1: torch.Tensor, x2: torch.Tensor,
                spk: torch.Tensor | None = None) -> LossTerms:
        """One train step on device batches, with this step's noise.  With
        the adversary, ``spk`` holds the speaker ids and the step's
        {"adv_ce", "adv_acc"} land in ``adv_metrics``.  Under a mesh the
        batches are this rank's rows and the terms and metrics returned
        are their means over the data axis."""
        self._gen.manual_seed(_step_seed(self.cfg.train.seed + 1, self.step))
        noise = ({"generator": self._gen} if self.mesh is None
                 else {"eps": self._rank_eps(x1.shape[0])})
        if self.adversary is None:
            terms = self.train_step(x1, x2, **noise)
        else:
            terms, self.adv_metrics = self.train_step(x1, x2, spk, **noise)
        if self.mesh is not None:
            means = torch.stack([*terms, *self.adv_metrics.values()])
            dist.all_reduce(means, group=self.mesh.data_group)
            means = (means / self.mesh.dp).unbind()
            terms = LossTerms(*means[:len(terms)])
            self.adv_metrics = dict(zip(self.adv_metrics, means[len(terms):]))
        self.step += 1
        return terms

    def _rank_eps(self, n: int) -> tuple[torch.Tensor, ...]:
        """This rank's n rows of the global batch's noise, drawn whole from
        the step's generator, so the sharded step is the one-process one."""
        rows = data_rows(n * self.mesh.dp, self.mesh)
        return tuple(e[rows] for e in draw_eps(self.model, n * self.mesh.dp, self._gen,
                                                self.device))

    # -- epoch loops ---------------------------------------------------------

    def _effective_batch_size(self, dataset, logging_func=print) -> int:
        """Partial batches are dropped, so a dataset smaller than the batch
        would train nothing: clamp to the pair count (a multiple of the
        data axis under a mesh), and fail loudly when that leaves none."""
        bs = self.cfg.train.batch_size
        n_pairs = len(dataset)
        if n_pairs >= bs:
            return bs
        dp = 1 if self.mesh is None else self.mesh.dp
        eff = n_pairs // dp * dp
        if n_pairs <= 0:
            raise ValueError("dataset yields no same-speaker pair; add data")
        if eff <= 0:
            raise ValueError(f"dataset yields only {n_pairs} same-speaker pairs, fewer than "
                             f"the {dp}-way data axis needs; start fewer processes or add data")
        if not self._clamp_logged:
            logging_func(f"batch_size {bs} > {n_pairs} available pairs; "
                         f"training with batch {eff}")
            self._clamp_logged = True
        return eff

    def _check_same_batch(self, *arrays) -> None:
        """Under a mesh every rank must walk the same pairing (a seeded
        dataset): compare a position-weighted sum of the host batch's rows
        across the ranks, one all-reduce, and refuse a batch they differ on."""
        c = sum(float(np.asarray(a, np.float64).reshape(len(a), -1).sum(1)
                      @ np.arange(1, len(a) + 1)) for a in arrays)
        t = torch.tensor([c, -c], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if t[0].item() != -t[1].item():
            raise RuntimeError("the ranks walked different batches: under a mesh the "
                               "dataset must be seeded alike on every rank")

    def train_epoch(self, dataset, epoch: int) -> dict[str, float]:
        """One pass over the paired dataset; returns the summed loss terms
        and the batch count."""
        from dvc_tpu_torch.data.dataset import prefetch

        self.model.train()
        keys = LossTerms._fields + (("adv_ce", "adv_acc") if self.adversary is not None else ())
        totals = torch.zeros(len(keys), dtype=torch.float64, device=self.device)
        n_batches = 0
        for x1, x2, spk in prefetch(dataset.batches(self._effective_batch_size(dataset))):
            if self.mesh is None:
                with span("train.h2d"):
                    spk = torch.from_numpy(np.asarray(spk, np.int64)).to(self.device)
                    x1, x2 = self._to_device(x1), self._to_device(x2)
            else:  # every rank walked the same batch: keep this rank's rows
                if n_batches == 0:
                    self._check_same_batch(x1, x2, spk)
                x1, x2, spk = shard_batch((x1, x2, np.asarray(spk, np.int64)), self.mesh)
            terms = self.step_on(x1, x2, spk)
            totals += torch.stack([*terms, *self.adv_metrics.values()]).to(torch.float64)
            n_batches += 1
        with span("train.epoch_tail"):
            dataset.shuffle_data()  # re-pair utterances (reference :96)
            out = dict(zip(keys, totals.tolist()))
        out["n_batches"] = n_batches
        return out

    def run_training(self, dataset, epochs: int, report_interval: int | None = None,
                     reload_model: bool = True, logging_func=print) -> list[dict]:
        """Train ``epochs`` epochs from the resume point (the reference's
        range(start_epoch, start_epoch + epochs)); returns each epoch's mean
        loss terms."""
        report_interval = report_interval or self.cfg.train.report_interval
        start_epoch = self.load_last() if reload_model else 1
        writer = self._get_writer()
        self._effective_batch_size(dataset, logging_func=logging_func)
        history = []
        for epoch in range(start_epoch, start_epoch + epochs):
            t0 = time.time()
            totals = self.train_epoch(dataset, epoch)
            n = max(totals.pop("n_batches"), 1)
            means = {k: v / n for k, v in totals.items()}
            history.append(means)
            logging_func(f"====> Epoch: {epoch} loss {means['total']:.4f} "
                         f"({time.time() - t0:.2f}s)")
            if writer is not None:
                # same scalar names as reference :187-191
                writer.add_scalar("Loss\\Reconstruction Loss1", means["mse_x1"], epoch)
                writer.add_scalar("Loss\\Reconstruction Loss2", means["mse_x2"], epoch)
                writer.add_scalar("Loss\\Z1 KL Loss", means["z1_kl"], epoch)
                writer.add_scalar("Loss\\Z2 KL Loss", means["z2_kl"], epoch)
                writer.add_scalar("Loss\\Z KL Style", means["z_style_kl"], epoch)
                if "adv_ce" in means:  # the adversarial content regularizer
                    writer.add_scalar("Loss\\Adversary CE", means["adv_ce"], epoch)
                    writer.add_scalar("Loss\\Adversary Acc", means["adv_acc"], epoch)
            if self.checkpoints_path and epoch % report_interval == 0:
                self.save(epoch)
                # the reference also dumps reconstruction PNGs each interval
                # (variational_base_vae.py:199-202); an optional artifact, so
                # a failure is reported and training goes on, as in dvc_tpu
                if self.estimation_dir:
                    try:
                        self.estimate_trained_model(dataset, self.estimation_dir,
                                                    logging_func=logging_func)
                    except Exception as e:
                        logging_func(f"estimation dump failed: {type(e).__name__}: {e}")
        if writer is not None:
            writer.flush()
        return history

    def evaluate(self, dataset, logging_func=print) -> dict[str, float]:
        """Eval-mode pass (reference test(), variational_base_vae.py:105-123):
        running BN statistics, the posteriors' means, mean loss terms.  The
        z_style noise is seeded with 0 for every batch, as dvc_tpu's
        PRNGKey(0)."""
        totals = np.zeros(len(LossTerms._fields), np.float64)
        n = 0
        gen = torch.Generator(device=self.device)
        for x1, x2, _spk in dataset.batches(self._effective_batch_size(dataset),
                                            shuffle=False):
            gen.manual_seed(0)
            terms = eval_terms(self.model, self._to_device(x1), self._to_device(x2),
                               gen, self.cfg.loss.mse_cof, self.cfg.loss.kl_cof)
            totals += torch.stack(terms).double().cpu().numpy()
            n += 1
        out = {k: float(v / max(n, 1)) for k, v in zip(LossTerms._fields, totals)}
        logging_func(f"====> Test recons loss: {out['mse_x1']:.4f} - "
                     f"VLB: {out['total']:.4f}")
        return out

    def estimate_trained_model(self, dataset, estimation_dir: str, n_images: int = 5,
                               logging_func=print) -> int:
        """Reload the latest checkpoint, reconstruct the first unshuffled
        batch in eval mode (z_style noise seeded 0, as ``evaluate``) and
        write up to ``n_images`` pairs of PNGs, ``{epoch}_recons_mel_{i}.png``
        (after the postnet) and ``{epoch}_original_mel_{i}.png`` (reference
        estimate_trained_model, model/variational_base_vae.py:205-239).
        Returns the checkpoint's epoch."""
        from dvc_tpu_torch.utils.plotting import save_mel_png
        epoch = self.load_last() - 1
        x1, x2, _ = next(iter(dataset.batches(self._effective_batch_size(dataset),
                                              shuffle=False)))
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.model.eval()
        try:
            with torch.no_grad():
                outs = self.model(self._to_device(x1), self._to_device(x2), generator=gen)
        finally:
            self.model.train()
        recons_x1 = outs[2].cpu().numpy()
        if not is_primary():  # every rank ran the forward; rank 0 writes
            return epoch
        os.makedirs(estimation_dir, exist_ok=True)
        failures = 0
        for i in range(min(n_images, len(x1))):
            # one bad PNG (matplotlib backend, disk) must not stop the rest
            try:
                save_mel_png(recons_x1[i], os.path.join(
                    estimation_dir, f"{epoch}_recons_mel_{i}.png"),
                    "reconstructed mel spectrogram")
                save_mel_png(x1[i], os.path.join(
                    estimation_dir, f"{epoch}_original_mel_{i}.png"),
                    "original mel spectrogram")
            except Exception as e:
                failures += 1
                if failures == 1:
                    logging_func(f"estimation png dump failed: {type(e).__name__}: {e}")
        if failures > 1:
            logging_func(f"estimation png dump: {failures} images failed")
        return epoch

    def _get_writer(self):
        if self._writer is None and self.logs_path and is_primary():
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: no writer, as dvc_tpu
                return None
            self._writer = SummaryWriter(f"{self.logs_path}/{self.run_name}")
        return self._writer

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
