"""Epochs of ``Trainer.train_epoch`` over a paired corpus, as run_training
calls it.

Set-up: a synthetic corpus under TMPDIR (the traffic's speakers, files a
speaker and lengths; mels as ``.npy`` or WORLD features as ``.npz``), the
program's Trainer at the configuration's batch with the VAE's weights from
the seed, its dataset (``PairedMelDataset`` or ``PairedMCCDataset``), and
one warm-up epoch that fills the dataset's cache.  That epoch's first
three steps are recorded for the judge as they run: the step's batches and
the state of its noise generator, its loss, Adam's first moments after the
first step and the parameters after the third.  The window runs whole
epochs until ``--seconds`` have passed; the last ends at train_epoch's own
synchronizing ``.tolist()``.  The window's last three batches, served
from the dataset's cache, are kept as they reach the step.

Judged after the window: the plain reference (reference/vae.py) trains the
same three steps from the same weights, batches and noise, in float32 with
TF32 off; and those three batches and the window's last three are held
against the corpus files (reference/pairs.py), exactly.
"""

from __future__ import annotations

import math
import shutil
import time

import numpy as np
import torch

from port_bench import common, corpus
from port_bench.reference import pairs as ref_pairs
from port_bench.reference import vae as ref_vae
from port_bench.trace import DeviceTrace, Spans
from port_bench.weights import vae_state_dict

SEEDS = ("weights", "corpus", "pairs", "trainer")
STEPS = 3


class StepRecorder:
    """Wraps the Trainer's step function; records its first three calls,
    and, once ``arm()`` is called, holds on to the batches of the last
    three calls (references only: no device work is added to a step)."""

    def __init__(self, trainer, p0: dict, variant: str | None, spans: Spans):
        self.trainer, self.inner, self.p0, self.variant = trainer, trainer.train_step, p0, variant
        self.spans, self.trace = spans, None
        self.inputs, self.losses = [], []
        self.grad1: dict[str, float] = {}
        self.change3: dict[str, float] = {}
        self.calls = 0
        self.ring, self.ring_calls = None, 0

    def arm(self) -> None:
        self.ring = [None] * STEPS

    def last_batches(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        n = min(self.ring_calls, STEPS)
        return [self.ring[(self.ring_calls - n + j) % STEPS] for j in range(n)]

    def __call__(self, x1, x2, generator=None, eps=None):
        with self.spans.span("train.step"):
            if self.ring is not None:
                self.ring[self.ring_calls % STEPS] = (x1, x2)
                self.ring_calls += 1
            terms = self._step(x1, x2, generator, eps)
        if self.trace is not None:
            self.trace.step()
        return terms

    def _step(self, x1, x2, generator, eps):
        i = self.calls
        self.calls += 1
        if i < STEPS:
            self.inputs.append((x1.clone(), x2.clone(), generator.get_state().clone()))
        if self.variant == "halfbatch":  # the fault: half the batch left out
            h = x1.shape[0] // 2
            x1, x2 = x1[:h], x2[:h]
        if self.variant == "frozen":  # the fault: a step that leaves the state as it was
            state = {k: v.clone() for k, v in self.trainer.model.state_dict().items()}
            terms = self.inner(x1, x2, generator=generator, eps=eps)
            self.trainer.model.load_state_dict(state)
        else:
            terms = self.inner(x1, x2, generator=generator, eps=eps)
        if i < STEPS:
            self.losses.append(terms.total.detach().clone())
        if i == 0:
            opt = self.trainer.optimizer
            b1 = opt.param_groups[0]["betas"][0]
            self.grad1 = {n: (opt.state[p]["exp_avg"] / (1 - b1)).norm().item()
                          for n, p in self.trainer.model.named_parameters()}
        if i == STEPS - 1:
            self.change3 = {n: (p.detach() - self.p0[n]).norm().item()
                            for n, p in self.trainer.model.named_parameters()}
        return terms


def _dataset(kind: str, root: str, frames: int, seed: int):
    from dvc_tpu_torch.data.dataset import PairedMCCDataset, PairedMelDataset
    cls = PairedMelDataset if kind == "mel" else PairedMCCDataset
    return cls(root, samples_length=frames, seed=seed)


def run(ctx) -> common.Outcome:
    root = common.scratch_dir("train")
    try:
        return _run(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, root: str) -> common.Outcome:
    from dvc_tpu_torch.config import Config, LossConfig, TrainConfig, VAEConfig
    from dvc_tpu_torch.train.trainer import Trainer

    cfg, tr = ctx.config, ctx.traffic
    vae, train = cfg["vae"], cfg["train"]
    dev = torch.device(ctx.device)
    seeds = common.sub_seeds(ctx.seed, SEEDS)
    spans = Spans()
    lap = common.Laps(ctx.t_start)
    lap("start")

    written = corpus.training_corpus(root, tr["features"], vae["num_mels"], tr["frames_per_s"],
                                     tr["speakers"], tr["files_per_speaker"], tr["lengths"],
                                     seeds["corpus"], dev)
    lap("corpus")
    pcfg = Config(vae=VAEConfig(**vae), loss=LossConfig(**cfg["loss"]),
                  train=TrainConfig(batch_size=train["batch_size"],
                                    learning_rate=train["learning_rate"],
                                    compute_dtype=train["compute_dtype"],
                                    seed=seeds["trainer"] % (2 ** 31)))
    trainer = Trainer(pcfg, device=dev)
    sd = vae_state_dict(vae, seeds["weights"], dev)
    trainer.model.load_state_dict(sd)
    p0 = {n: sd[n].clone() for n, _ in trainer.model.named_parameters()}
    rec = StepRecorder(trainer, p0, ctx.variant, spans)
    trainer.train_step = rec
    ds = _dataset(tr["features"], root, vae["frames"], seeds["pairs"] % (2 ** 32))

    lap("trainer")
    with spans.span("train.warmup_epoch"):
        trainer.train_epoch(ds, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        setup_peak = 0
    rec.arm()
    if ctx.variant == "stalecache":  # the fault: the dataset's cache serves altered data
        for k, v in ds._cache.items():
            ds._cache[k] = v[::-1].copy()
    lap("warm_up_epoch")

    trace = None
    if ctx.trace:
        ts = ctx.settings["trace_steps"]
        trace = rec.trace = DeviceTrace(ts["wait"], ts["active"])
        trace.start()
    steps = epochs = 0
    t_w0 = time.perf_counter()
    wall0 = time.time_ns()
    setup_s = t_w0 - ctx.t_start
    while time.perf_counter() - t_w0 < ctx.seconds:
        epochs += 1
        with spans.span("train.epoch", epoch=epochs):
            steps += trainer.train_epoch(ds, epochs)["n_batches"]
    t_end = time.perf_counter()
    wall1 = wall0 + int((t_end - t_w0) * 1e9)
    if trace is not None:
        trace.stop()
        rec.trace = None
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = t_end - t_w0
    b, f = train["batch_size"], vae["frames"]
    e2e = {"train_frames_per_s": 2 * b * f * steps / window, "setup_s": setup_s}
    records = {"spans": spans.items, "window_ns": (wall0, wall1), "window_s": window,
               "trace_window_ns": trace.window() if trace is not None and trace.kernels else None,
               "steps": steps, "epochs": epochs, "config": cfg, "trace": trace,
               "window_peak_bytes": window_peak, "corpus_bytes": written}
    losses = [x.item() for x in rec.losses]
    inputs, grad1, change3 = rec.inputs, rec.grad1, rec.change3
    judged = [(a.cpu().numpy(), b.cpu().numpy()) for a, b, _ in inputs] + \
        [(a.cpu().numpy(), b.cpu().numpy()) for a, b in rec.last_batches()]
    del trainer, rec, ds
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.variant == "control":  # the reference in TF32, in the program's place
        ctl = reference_steps(cfg, sd, inputs, dev, tf32=True)
        losses, grad1, change3 = ctl["losses"], ctl["grad1"], ctl["change3"]
    ref = reference_steps(cfg, sd, inputs, dev, tf32=False)
    checks = judge(ctx.settings["limits"], losses, grad1, change3, ref)
    data = ref_pairs.Corpus(root, tr["features"])
    checks.append(common.Check("batch_rows_off", float(sum(data.rows_off(a, b)
                                                           for a, b in judged)), 0.0))
    return common.Outcome(attempted=steps, failed=0, end_to_end=e2e,
                          memory_peak_bytes=int(max(setup_peak, window_peak)), checks=checks,
                          records=records, notes=lap.items)


def reference_steps(cfg: dict, sd: dict, inputs: list, dev, tf32: bool) -> dict:
    """Three train steps of the plain reference from the weights ``sd`` on
    the recorded batches and noise: each step's loss, each leaf's gradient
    norm at step 1 and change norm after step 3."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    vae = cfg["vae"]
    m = ref_vae.on_device(vae, sd, dev)
    params = dict(m.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = ref_vae.Adam(params, cfg["train"]["learning_rate"])
    c, s = vae["latent_dim"] - vae["speaker_size"], vae["speaker_size"]
    losses, grad1 = [], {}
    for i, (x1, x2, state) in enumerate(inputs):
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        b = x1.shape[0]
        eps = tuple(torch.randn((b, n), generator=gen, device=dev) for n in (c, c, s))
        loss = ref_vae.pair_loss(m, x1, x2, eps, cfg["loss"]["mse_cof"], cfg["loss"]["kl_cof"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if i == 0:
            grad1 = {k: g.norm().item() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(loss.item())
    change3 = {k: (p.detach() - start[k]).norm().item() for k, p in params.items()}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"losses": losses, "grad1": grad1, "change3": change3}


def gaps(losses, grad1, change3, ref) -> dict[str, float]:
    """loss_gap: the worst step's |loss - reference| over |reference|;
    grad_gap and change_gap: the worst leaf's gap of norms over the larger
    of the reference leaf's norm and the median leaf's.  Leaves whose
    reference gradient is under a thousandth of the median leaf's (biases
    ahead of a BatchNorm, which Adam moves by round-off alone) are left
    out of both."""
    if len(losses) < STEPS or len(ref["losses"]) < STEPS:
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    med_g = float(np.median(list(ref["grad1"].values())))
    kept = [k for k, v in ref["grad1"].items() if v >= 1e-3 * med_g]
    med_c = float(np.median([ref["change3"][k] for k in kept]))

    def worst(got, want, med):
        return max(abs(got.get(k, math.inf) - want[k]) / max(want[k], med) for k in kept)
    return {"loss_gap": loss_gap, "grad_gap": worst(grad1, ref["grad1"], med_g),
            "change_gap": worst(change3, ref["change3"], med_c)}


def judge(limits: dict, losses, grad1, change3, ref) -> list[common.Check]:
    g = gaps(losses, grad1, change3, ref)
    return [common.Check(k, float(v), limits[k]) for k, v in g.items()]
