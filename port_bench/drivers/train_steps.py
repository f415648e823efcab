"""Steps of ``VocoderTrainer.train_steps`` over ``wav_batches``, as the
program's ``train-vocoder`` runs them.

Set-up: a corpus of 16-bit wavs under TMPDIR (the traffic's speakers and
files a speaker; one stratified set of log-normal lengths, which every
seed deals out in its own order; speech-like audio from corpus.speech),
the program's VocoderTrainer at the configuration's widths and learning
rate with its own initialisation drawn from the seed, ``wav_batches`` over
the corpus at the configuration's batch and crop, and one warm-up call of
``steps_per_call`` steps.  That call's first three steps are recorded for
the judge as they run: the batch, the state of the dropout generator, the
loss, Adam's first moments after the first step, and the parameters and
the EMA trail after the third.  The window runs calls of
``steps_per_call`` steps (the command's logging period, so each call
synchronizes where ``train-vocoder`` does, ending at train_steps' own
``.tolist()``) until ``--seconds`` have passed; the window's last three
batches are kept as they reach the step.

Judged after the window: the plain reference (reference/wavenet_train.py)
trains the same three steps from the same weights, batches and generator
states in float32 with TF32 off: ``loss_gap``, ``grad_gap`` and
``change_gap`` as train_epochs.gaps reads them; ``grad_err``, the first
step's gradients against the reference's element by element (the median
leaf's relative distance), and ``ema_gap``, the trail after the third
step against the reference's over the reference trail's move from the
initial weights, every leaf in one vector.  Those three batches and the window's last three are held
against the corpus and the reference front end: ``crop_rows_off`` counts
rows that are not a hop-aligned crop of a corpus wav, and ``cond_err`` is
the largest distance of a row's conditioning from the reference mel of
its samples.
"""

from __future__ import annotations

import glob
import math
import os
import shutil
import time

import numpy as np
import torch

from port_bench import common, corpus
from port_bench.drivers.train_epochs import gaps
from port_bench.reference import audio as ref_audio
from port_bench.reference import wavenet_train as ref_train
from port_bench.trace import DeviceTrace, Spans

SEEDS = ("corpus", "crops", "trainer")
STEPS = 3
KEY = 64  # samples that index a crop's start in the corpus


class StepRecorder:
    """Wraps the trainer's step function; records its first three calls,
    and, once ``arm()`` is called, holds on to the batches of the last
    three calls (references only: no device work is added to a step)."""

    def __init__(self, trainer, variant: str | None, spans: Spans):
        self.trainer, self.inner = trainer, trainer.step_fn
        self.variant, self.spans = variant, spans
        self.params = dict(trainer.model.named_parameters())
        self.p0 = {n: p.detach().clone() for n, p in self.params.items()}
        self.trace = None
        self.inputs, self.losses = [], []
        self.grad1: dict[str, torch.Tensor] = {}
        self.change3: dict[str, float] = {}
        self.ema3: dict[str, torch.Tensor] = {}
        self.calls = 0
        self.ring, self.ring_calls = None, 0

    def arm(self) -> None:
        self.ring = [None] * STEPS

    def last_batches(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        n = min(self.ring_calls, STEPS)
        return [self.ring[(self.ring_calls - n + j) % STEPS] for j in range(n)]

    def __call__(self, x, c, t, generator=None):
        with self.spans.span("train.step"):
            if self.variant == "shiftcond":  # the fault: the conditioning one frame late
                c = torch.cat([c[:, :1], c[:, :-1]], 1)
            if self.ring is not None:
                self.ring[self.ring_calls % STEPS] = (x, c)
                self.ring_calls += 1
            loss = self._step(x, c, t, generator)
        if self.trace is not None:
            self.trace.step()
        return loss

    def _step(self, x, c, t, generator):
        i = self.calls
        self.calls += 1
        if i < STEPS:
            self.inputs.append((x.clone(), c.clone(), generator.get_state().clone()))
        if self.variant == "halfbatch":  # the fault: half the batch left out
            h = x.shape[0] // 2
            x, c = x[:h], c[:h]
        if self.variant == "frozen":  # the fault: a step that leaves the weights as they were
            state = {n: p.detach().clone() for n, p in self.params.items()}
            loss = self.inner(x, c, t, generator)
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(state[n])
        elif self.variant == "staleema":  # the fault: the trail follows the weights before Adam
            from dvc_tpu_torch.train.vocoder_trainer import ema_update_
            before = {n: p.detach().clone() for n, p in self.params.items()}
            trail = {n: e.clone() for n, e in self.trainer.ema.items()}
            loss = self.inner(x, c, t, generator)
            for n, e in self.trainer.ema.items():
                e.copy_(trail[n])
            ema_update_(self.trainer.ema, before, t)
        else:
            loss = self.inner(x, c, t, generator)
        if i < STEPS:
            self.losses.append(loss.detach().clone())
        if i == 0:  # the gradients stay until the next step's zero_grad
            # a leaf without one (the last layer's residual product feeds
            # nothing) reads zeros, and Adam leaves it where it was
            self.grad1 = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                          for n, p in self.params.items()}
        if i == STEPS - 1:
            self.change3 = {n: (p.detach() - self.p0[n]).norm().item()
                            for n, p in self.params.items()}
            self.ema3 = {n: e.clone() for n, e in self.trainer.ema.items()}
        return loss


def write_corpus(root: str, tr: dict, seed: int, device) -> int:
    """``root/pNNN/uttMM.wav``: 16-bit PCM at the traffic's rate, one
    speaker's utterances on its own base pitch.  Returns the bytes
    written."""
    sr, spk, files = tr["sample_rate"], tr["speakers"], tr["files_per_speaker"]
    ln = tr["lengths"]
    secs = corpus.stratified_lengths(spk * files, ln["median_s"], ln["sigma"], ln["min_s"],
                                     ln["max_s"])
    order = np.random.default_rng(seed).permutation(spk * files)
    written = 0
    for s in range(spk):
        d = os.path.join(root, f"p{s:03d}")
        os.makedirs(d, exist_ok=True)
        lengths = [int(secs[order[s * files + u]] * sr) for u in range(files)]
        f0 = 90.0 + 160.0 * s / max(spk - 1, 1)
        for u, w in enumerate(corpus.speech(lengths, sr, common.derive(seed, s), device, f0)):
            body = corpus.pcm16_wav(w, sr)
            with open(os.path.join(d, f"utt{u:02d}.wav"), "wb") as f:
                f.write(body)
            written += len(body)
    return written


class WavCorpus:
    """The corpus as written, read back with the reference's wav reader:
    every hop-aligned start at which a whole crop fits, indexed by its
    first KEY samples."""

    def __init__(self, root: str, crop: int, hop: int):
        self.index: dict[bytes, list[tuple[np.ndarray, int]]] = {}
        for fp in sorted(glob.glob(os.path.join(root, "**", "*.wav"), recursive=True)):
            with open(fp, "rb") as f:
                pcm, _ = ref_audio.pcm16_of(f.read())
            for s in range(0, len(pcm) - crop + 1, hop):
                self.index.setdefault(pcm[s:s + KEY].tobytes(), []).append((pcm, s))

    def rows_off(self, x: np.ndarray) -> int:
        """The rows of x (B, T, 1) that are not exactly a crop: 16-bit
        samples over 32768 at a hop-aligned start of a corpus wav."""
        off = 0
        for row in x[..., 0]:
            q = np.round(row.astype(np.float64) * 32768.0)
            if not (np.array_equal(q / 32768.0, row) and np.abs(q).max() <= 32767):
                off += 1
                continue
            q = q.astype(np.int16)
            found = self.index.get(q[:KEY].tobytes(), [])
            off += not any(np.array_equal(pcm[s:s + len(q)], q) for pcm, s in found)
        return off


def cond_err(x: np.ndarray, c: np.ndarray, audio: dict) -> float:
    """The largest |c - the reference mel of x's rows|, its frames cut to
    c's (the upsampler's contract)."""
    worst = 0.0
    for b in range(x.shape[0]):
        mel = ref_audio.melspectrogram(torch.from_numpy(x[b, :, 0]), audio).T.numpy()
        if mel.shape[0] < c.shape[1] or mel.shape[1] != c.shape[2]:
            return math.inf
        worst = max(worst, float(np.abs(mel[:c.shape[1]] - c[b]).max()))
    return worst


def run(ctx) -> common.Outcome:
    root = common.scratch_dir("wav")
    try:
        return _run(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, root: str) -> common.Outcome:
    from dvc_tpu_torch.config import AudioConfig, VocoderConfig
    from dvc_tpu_torch.train.vocoder_trainer import VocoderTrainer, wav_batches

    cfg, tr = ctx.config, ctx.traffic
    voc, train, audio = cfg["vocoder"], cfg["train"], cfg["audio"]
    dev = torch.device(ctx.device)
    seeds = common.sub_seeds(ctx.seed, SEEDS)
    spans = Spans()
    lap = common.Laps(ctx.t_start)
    lap("start")

    written = write_corpus(root, tr, seeds["corpus"], dev)
    lap("corpus")
    vcfg = VocoderConfig(**dict(voc, upsample_scales=tuple(voc["upsample_scales"])))
    trainer = VocoderTrainer(vcfg, lr=train["learning_rate"], seed=seeds["trainer"] % (2 ** 31),
                             device=dev)
    rec = StepRecorder(trainer, ctx.variant, spans)
    trainer.step_fn = rec
    b, hop = train["batch_size"], math.prod(voc["upsample_scales"])
    crop = train["max_time_steps"] // hop * hop
    batches = wav_batches(root, b, train["max_time_steps"], vcfg, seed=seeds["crops"] % (2 ** 32),
                          audio_cfg=AudioConfig(**audio))
    per_call = tr["steps_per_call"]

    def quiet(_msg: str) -> None:
        pass

    lap("trainer")
    with spans.span("train.warmup_call"):
        trainer.train_steps(batches, per_call, logging_func=quiet)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        setup_peak = 0
    rec.arm()
    lap("warm_up_call")

    trace = None
    if ctx.trace:
        ts = ctx.settings["trace_steps"]
        trace = rec.trace = DeviceTrace(ts["wait"], ts["active"])
        trace.start()
    steps = calls = 0
    t_w0 = time.perf_counter()
    wall0 = time.time_ns()
    setup_s = t_w0 - ctx.t_start
    while time.perf_counter() - t_w0 < ctx.seconds:
        calls += 1
        with spans.span("train.call", call=calls):
            trainer.train_steps(batches, per_call, logging_func=quiet)
        steps += per_call
    t_end = time.perf_counter()
    wall1 = wall0 + int((t_end - t_w0) * 1e9)
    if trace is not None:
        trace.stop()
        rec.trace = None
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = t_end - t_w0
    frames = crop // hop
    e2e = {"train_frames_per_s": b * frames * steps / window, "setup_s": setup_s}
    records = {"spans": spans.items, "window_ns": (wall0, wall1), "window_s": window,
               "trace_window_ns": trace.window() if trace is not None and trace.kernels else None,
               "steps": steps, "calls": calls, "config": cfg, "trace": trace,
               "window_peak_bytes": window_peak, "corpus_bytes": written}
    losses = [x.item() for x in rec.losses]
    got = {"losses": losses, "grad1": rec.grad1, "change3": rec.change3, "ema": rec.ema3}
    inputs, p0 = rec.inputs, rec.p0
    judged = [(x.cpu().numpy(), c.cpu().numpy()) for x, c, _ in inputs] + \
        [(x.cpu().numpy(), c.cpu().numpy()) for x, c in rec.last_batches()]
    del trainer, rec, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.variant == "control":  # the reference in TF32, in the program's place
        got = reference_steps(cfg, p0, inputs, dev, tf32=True)
    ref = reference_steps(cfg, p0, inputs, dev, tf32=False)
    checks = judge(ctx.settings["limits"], got, ref, p0)
    data = WavCorpus(root, crop, hop)
    checks.append(common.Check("crop_rows_off", float(sum(data.rows_off(x) for x, _ in judged)),
                               ctx.settings["limits"]["crop_rows_off"]))
    checks.append(common.Check("cond_err", max((cond_err(x, c, audio) for x, c in judged),
                                               default=math.inf),
                               ctx.settings["limits"]["cond_err"]))
    return common.Outcome(attempted=steps, failed=0, end_to_end=e2e,
                          memory_peak_bytes=int(max(setup_peak, window_peak)), checks=checks,
                          records=records, notes=lap.items)


def reference_steps(cfg: dict, p0: dict, inputs: list, dev, tf32: bool) -> dict:
    """Three train steps of the plain reference from the weights ``p0`` on
    the recorded batches and generator states: each step's loss, the
    gradients of step 1, each leaf's change norm after step 3, and the
    trail after step 3."""
    out = ref_train.train(p0, cfg["vocoder"], inputs, cfg["train"]["learning_rate"], dev,
                          tf32=tf32)
    return {"losses": out["losses"], "grad1": out["grads1"],
            "change3": {k: (p - p0[k]).norm().item() for k, p in out["params"].items()},
            "ema": out["ema"]}


def pooled_gap(got: dict, want: dict, base: dict) -> float:
    """||got - want|| over ||want - base||, every leaf in one vector."""
    if set(got) != set(want):
        return math.inf
    dev = next(iter(want.values())).device
    off = sum((got[k].to(dev) - want[k]).square().sum() for k in want)
    moved = sum((want[k] - base[k].to(dev)).square().sum() for k in want)
    return math.sqrt(off.item() / moved.item())


def leaf_err(got: dict, want: dict) -> float:
    """The median over leaves of ||got - want|| / ||want||, leaves whose
    reference is zero left out.  The median, because a leaf of few
    elements (the upsampler's biases) sums its gradient over the whole
    crop with cancellation, and rounding alone moves it by 1e-4 of
    itself; a lower precision moves every leaf."""
    if set(got) != set(want):
        return math.inf
    errs = [(got[k].to(w.device) - w).norm().item() / w.norm().item()
            for k, w in want.items() if w.any()]
    return float(np.median(errs)) if errs else math.inf


def judge(limits: dict, got: dict, ref: dict, p0: dict) -> list[common.Check]:
    """train_epochs.gaps on the first step's gradient norms; ``grad_err``,
    that step's gradients against the reference's element by element
    (leaf_err); ``ema_gap``, the trail after step 3 against the
    reference's over the reference trail's move, every leaf in one vector:
    Adam moves every weight by about the learning rate whatever its
    gradient's size, so a gradient element that rounding takes across zero
    moves its weight by twice that, which a single leaf's norm, or
    element, would read as a fault."""
    def norms(grads):
        return {k: g.norm().item() for k, g in grads.items()}
    g = gaps(got["losses"], norms(got["grad1"]), got["change3"],
             dict(ref, grad1=norms(ref["grad1"])))
    g["grad_err"] = leaf_err(got["grad1"], ref["grad1"])
    g["ema_gap"] = pooled_gap(got["ema"], ref["ema"], p0)
    return [common.Check(k, float(v), limits[k]) for k, v in g.items()]
