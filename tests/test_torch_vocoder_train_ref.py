"""The port's WaveNet vocoder training against the benchmark's plain
reference (port_bench/reference/wavenet_train.py) on the CPU, at a small
width: the forward at dropout 0 and with the dropout masks replayed from
the generator's state, the MoL NLL on each of its branches, one step's
gradients, three ``VocoderTrainer.step_on`` steps with Adam and the EMA
trail, and the trainer's spans (recorded once a step, in order, only while
a profiler records, and changing no arithmetic).

The reference is the one the benchmark's ``train-vocoder-b2`` cell judges
the card with; it imports nothing of the port.  Weights are the trainer's
own seeded initialisation, moved off its constant and zero parts by seeded
noise so that every leaf matters."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.models.wavenet import discretized_mix_logistic_loss
from dvc_tpu_torch.train.trainer import _step_seed
from dvc_tpu_torch.train.vocoder_trainer import VocoderTrainer, create_wavenet, ema_decay_at
from dvc_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from port_bench.reference import wavenet_train as ref  # noqa: E402

SMALL = dict(layers=6, stacks=2, residual_channels=32, gate_channels=32, skip_out_channels=16,
             cin_channels=8, upsample_scales=(2, 2))
B, T = 2, 128
CFG = VocoderConfig(**SMALL)
VOC = dataclasses.asdict(CFG)
LR = 1e-3
# The forward, masked or not, over its output's max: float32 sums in
# another order (a conv against one product of the stacked taps) through
# 6 layers and the head, 2.6e-7 and 2.9e-7 of the max; 1e-5 leaves 30x.
FWD_TOL = 1e-5
# The MoL NLL, relative: the same float32 transcendentals written another
# way (logsigmoid against x - softplus(x)), a few ulps of a mean.
NLL_RTOL = 1e-6
# Each gradient over its leaf's max |g|: one backward through the same
# sums in another order, about 1e-6 of the max.
GRAD_TOL = 1e-4
# Parameters and the trail after three Adam steps, per leaf, as the norm
# of their distance from the reference's over the norm of the reference
# leaf's move: Adam moves every element by about the learning rate
# whatever its gradient's size, so a gradient element near zero carries
# its rounding into its step, and the biases start at zero, so their max
# is their steps.  Seen up to 5.5e-5 on seeds 0-5 at 1 and 8 threads;
# 3e-4 leaves 5x, and a trail one step late reads about 0.3.
STEP_TOL = 3e-4
# The trail against the ramp applied to the trainer's own parameters: a
# blend of four float32 states, a few ulps of the leaf's max.
EMA_TOL = 1e-6
SPANS = ["train.data_wait", "train.h2d", "train.forward", "train.backward", "train.optimizer",
         "train.ema"]


def seeded_model(seed):
    model = create_wavenet(CFG, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def batch(seed):
    g = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn(B, T, 1, generator=g)).clamp(-1, 1)
    return x, torch.rand(B, T // 4, CFG.cin_channels, generator=g)


def leaf_gap(got, want):
    """max |got - want| over max |want|; a leaf of zeros must be matched
    exactly."""
    top = want.abs().max().item()
    if top == 0.0:
        return 0.0 if torch.equal(got, want) else float("inf")
    return (got - want).abs().max().item() / top


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_at_dropout_0(seed):
    model, sd = seeded_model(seed)
    x, frames = batch(seed)
    with torch.no_grad():
        got = model(x, frames, train=False)
        want = ref.forward(sd, VOC, x, frames)
    assert got.shape == want.shape == (B, T, CFG.out_channels)
    assert leaf_gap(got, want) < FWD_TOL


@pytest.mark.parametrize("seed", [2, 3])
def test_dropout_masks_replayed_from_the_generator_state(seed):
    model, sd = seeded_model(seed)
    x, frames = batch(seed)
    gen = torch.Generator().manual_seed(_step_seed(seed + 1, 0))
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    with torch.no_grad():
        got = model(x, frames, train=True, generator=gen)
        want = ref.forward(sd, VOC, x, frames, generator=replay)
        plain = ref.forward(sd, VOC, x, frames)
    assert leaf_gap(got, want) < FWD_TOL
    assert leaf_gap(plain, want) > 100 * FWD_TOL  # the masks dropped something
    assert torch.equal(gen.get_state(), replay.get_state())  # and drew as many numbers


def mol_case(branch):
    """y_hat (2, 64, 30) and y (2, 64, 1) that send every mixture to one
    branch of the NLL."""
    g = torch.Generator().manual_seed(7)
    n, k = 64, 10
    logits = torch.randn(2, n, k, generator=g)
    y = (torch.rand(2, n, 1, generator=g) * 1.6 - 0.8)
    if branch == "lowest bin":
        y = torch.full_like(y, -1.0)
        mu, log_s = torch.rand(2, n, k, generator=g) * 0.4 - 1.0, torch.full((2, n, k), -3.0)
    elif branch == "highest bin":
        y = torch.full_like(y, 1.0)
        mu, log_s = torch.rand(2, n, k, generator=g) * 0.4 + 0.6, torch.full((2, n, k), -3.0)
    elif branch == "inner bin's mass":  # narrow logistics near y: mass above 1e-5
        mu = y + 0.01 * torch.randn(2, n, k, generator=g)
        log_s = torch.full((2, n, k), -4.0)
    elif branch == "inner bin's density":  # wide logistics: mass under 1e-5
        mu, log_s = torch.randn(2, n, k, generator=g), torch.full((2, n, k), 1.5)
    else:  # all of them, and log scales under the clamp
        y[0, :8] = -1.0
        y[1, :8] = 1.0
        mu = torch.randn(2, n, k, generator=g) * 0.5
        log_s = torch.randn(2, n, k, generator=g) * 3.0 - 4.0
        log_s[0, 8:12] = -40.0
    return torch.cat([logits, mu, log_s], -1), y


@pytest.mark.parametrize("branch", ["lowest bin", "highest bin", "inner bin's mass",
                                    "inner bin's density", "mixed"])
def test_mol_nll_on_each_branch(branch):
    y_hat, y = mol_case(branch)
    if branch in ("inner bin's mass", "inner bin's density"):
        s = torch.exp(-y_hat[..., 20:])
        mass = torch.sigmoid(s * (y - y_hat[..., 10:20] + 1 / 65535)) - \
            torch.sigmoid(s * (y - y_hat[..., 10:20] - 1 / 65535))
        assert bool((mass > 1e-5).all()) == (branch == "inner bin's mass")
        assert bool((mass < 1e-5).all()) == (branch == "inner bin's density")
    got = discretized_mix_logistic_loss(y_hat, y, log_scale_min=CFG.log_scale_min)
    want = ref.mol_nll(y_hat, y, CFG.log_scale_min)
    assert abs(got.item() - want.item()) <= NLL_RTOL * abs(want.item())


def test_one_steps_gradients():
    model, sd = seeded_model(4)
    x, frames = batch(4)
    seed = _step_seed(5, 0)
    y_hat = model(x, frames, train=True, generator=torch.Generator().manual_seed(seed))
    loss = discretized_mix_logistic_loss(y_hat[:, :-1], x[:, 1:], log_scale_min=CFG.log_scale_min)
    loss.backward()
    params = {k: v.clone().requires_grad_() for k, v in sd.items()}
    want_loss = ref.step_loss(params, VOC, x, frames, torch.Generator().manual_seed(seed))
    grads = torch.autograd.grad(want_loss, list(params.values()), allow_unused=True)
    assert abs(loss.item() - want_loss.item()) <= NLL_RTOL * abs(want_loss.item())
    for (name, p), want in zip(model.named_parameters(), grads):
        if p.grad is None:  # the last layer's residual product feeds nothing
            assert want is None or not want.any(), name
        else:
            assert leaf_gap(p.grad, want) < GRAD_TOL, name


@pytest.mark.parametrize("seed", [0, 3])
def test_three_trainer_steps_with_adam_and_the_trail(seed):
    tr = VocoderTrainer(CFG, lr=LR, seed=seed, device="cpu")
    sd = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    batches, trajectory = [], []
    for t in range(3):
        x, frames = batch(seed + 50 + t)
        state = torch.Generator().manual_seed(_step_seed(seed + 1, t)).get_state()
        batches.append((x, frames, state))
        tr.step_on(x, frames)
        trajectory.append({n: p.detach().clone() for n, p in tr.model.named_parameters()})
    want = ref.train(sd, VOC, batches, LR, "cpu")
    for name, p in tr.model.named_parameters():
        moved = (want["params"][name] - sd[name]).norm().item()
        for got, exp in ((p.detach(), want["params"][name]), (tr.ema[name], want["ema"][name])):
            if moved == 0.0:  # a leaf without a gradient stays where it was
                assert torch.equal(got, sd[name]), name
            else:
                assert (got - exp).norm().item() <= STEP_TOL * moved, name
    # the trail is the ramp over the trainer's own parameters
    for name, e in tr.ema.items():
        trail = sd[name].clone()
        for t, w in enumerate(trajectory):
            d = ema_decay_at(t)
            assert d == pytest.approx(ref.ema_decay(t), rel=1e-7)
            trail = d * trail + (1 - d) * w[name]
        assert leaf_gap(e, trail) <= EMA_TOL, name


def batches_forever(seed):
    g = np.random.RandomState(seed)
    while True:
        yield ((0.3 * g.randn(B, T, 1)).clip(-1, 1).astype(np.float32),
               g.rand(B, T // 4, CFG.cin_channels).astype(np.float32))


def test_spans_once_a_step_in_order_and_only_while_a_profiler_records():
    profiling.clear()
    tr = VocoderTrainer(CFG, lr=LR, seed=6, device="cpu")
    tr.train_steps(batches_forever(6), 2, logging_func=lambda _m: None)
    assert profiling.recorded() == []
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_steps(batches_forever(7), 3, logging_func=lambda _m: None)
    spans = sorted(profiling.recorded(), key=lambda r: r["t0"])
    profiling.clear()
    assert [s["name"] for s in spans] == SPANS * 3
    assert all(s["t0"] <= s["t1"] for s in spans)
    assert all(a["t1"] <= b["t0"] for a, b in zip(spans, spans[1:]))


def test_spans_change_no_arithmetic():
    runs = []
    for traced in (False, True):
        profiling.clear()
        tr = VocoderTrainer(CFG, lr=LR, seed=8, device="cpu")
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                losses = tr.train_steps(batches_forever(8), 3, logging_func=lambda _m: None)
            assert profiling.recorded()
        else:
            losses = tr.train_steps(batches_forever(8), 3, logging_func=lambda _m: None)
        runs.append((losses, {n: p.detach().clone() for n, p in tr.model.named_parameters()},
                     {n: e.clone() for n, e in tr.ema.items()}))
    profiling.clear()
    (l0, p0, e0), (l1, p1, e1) = runs
    assert l0 == l1
    assert all(torch.equal(p0[n], p1[n]) and torch.equal(e0[n], e1[n]) for n in p0)
