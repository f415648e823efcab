"""The WaveNet MoL vocoder's train step, in plain PyTorch and float32.

The published vocoder, r9y9's wavenet_vocoder as the reference system
configures and trains it (preprocessing/hparams.py:82-151 of
v-manhlt3/Disentangle-VAE-for-VC, behind its published
``checkpoint_step001000000_ema.pth``): a teacher-forced forward over a
crop, the discretized mixture-of-logistics NLL of each next sample, its
gradients by autograd, Adam (reference/vae.py's) and an exponential
moving average of the weights.  Nothing here is the program's code; the
parameters are a state dict under the checkpoint's names.

One step, written out:

  * the conditioning frames go through the ConvTranspose2d + ReLU stack
    (reference/wavenet.py's ``upsample``) to one vector a sample;
  * a 1x1 conv takes the waveform to the residual channels; each of the L
    layers (dilation 2^(l mod L/stacks)) forms its gate input from the
    causal taps t - 2d, t - d and t of its input and the conditioning, as
    one product in (B, T, C) layout; tanh x sigmoid; a skip and a residual
    product; the residual sums with the layer's input times sqrt(1/2), the
    skips sum times sqrt(1/2) (``legacy``);
  * training drops each layer's input to the taps with probability
    ``dropout`` (inverted: the kept values divided by 1 - dropout), and the
    residual keeps the undropped input.  The masks are replayed from the
    generator the program drew them from: ``torch.rand((B, R, T)) < keep``
    on the step's device, layer by layer, nothing drawn in between;
  * ReLU, 1x1 conv, ReLU, 1x1 conv to 3K mixture parameters; the loss is
    the mean NLL of x[t + 1] under step t's mixture (all three branches of
    the discretized logistic: both edge bins, and the density at the bin's
    centre where its mass is under 1e-5);
  * Adam 1e-3 (betas 0.9, 0.999, eps 1e-8); then the trail
    ema <- d ema + (1 - d) w with d = min(0.9999, (1 + t) / (10 + t)), t
    the steps before this one.

Departures from the published recipe, shared with the program:

  * r9y9 trains weight-normalised convolutions (g v / ||v||, the norms
    recomputed every step); here, as in the program, the fused weights
    are the parameters.  Adam's trajectory differs; a step's arithmetic
    differs by a few norms of 25M elements.
  * r9y9 decays the learning rate stepwise; here it stays 1e-3, as the
    program's ``train-vocoder`` runs.

TF32 is off (``tf32=False``) unless a control asks for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.vae import Adam
from port_bench.reference.wavenet import upsample

SQRT_HALF = math.sqrt(0.5)
EMA_DECAY = 0.9999


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _tap(h: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, R) -> the input k steps back, zeros before the crop."""
    return F.pad(h, (0, 0, k, 0))[:, :h.shape[1]] if k else h


def forward(sd: dict, voc: dict, x: torch.Tensor, frames: torch.Tensor,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """x (B, T, 1) waveform, frames (B, T // hop, C) -> y_hat (B, T, 3K).

    With ``generator``, each layer's input is dropped with a mask drawn
    from it as the program draws it; without, nothing is dropped."""
    cond = upsample(sd, voc, frames)                              # (B, T, C)
    b, t, _ = x.shape
    if cond.shape[1] != t:
        raise ValueError(f"conditioning {tuple(cond.shape)} does not cover {tuple(x.shape)}")
    L, R = voc["layers"], voc["residual_channels"]
    S, G2 = voc["skip_out_channels"], voc["gate_channels"] // 2
    per_stack = L // voc["stacks"]
    keep = 1.0 - voc["dropout"]
    h = x * sd["first_conv.weight"][:, 0, 0] + sd["first_conv.bias"]   # (B, T, R)
    skips = None
    for li in range(L):
        d = 2 ** (li % per_stack)
        p = f"conv_layers.{li}."
        hin = h
        if generator is not None and keep < 1.0:
            mask = torch.rand((b, R, t), generator=generator, device=x.device) < keep
            hin = torch.where(mask.transpose(1, 2), h / keep, torch.zeros((), device=x.device))
        w = sd[p + "conv.weight"]                                  # (G, R, 3): taps t-2d, t-d, t
        w_in = torch.cat([w[:, :, 0], w[:, :, 1], w[:, :, 2], sd[p + "conv1x1c.weight"][:, :, 0]],
                         1)
        pre = torch.cat([_tap(hin, 2 * d), _tap(hin, d), hin, cond], 2) @ w_in.T \
            + sd[p + "conv.bias"]
        gated = torch.tanh(pre[..., :G2]) * torch.sigmoid(pre[..., G2:])
        w_so = torch.cat([sd[p + "conv1x1_skip.weight"][:, :, 0],
                          sd[p + "conv1x1_out.weight"][:, :, 0]], 0)
        so = gated @ w_so.T + torch.cat([sd[p + "conv1x1_skip.bias"], sd[p + "conv1x1_out.bias"]])
        h = (so[..., S:] + h) * SQRT_HALF
        s = so[..., :S]
        skips = s if skips is None else (skips + s) * (SQRT_HALF if voc["legacy"] else 1.0)
    o = F.relu(F.relu(skips) @ sd["last_conv_layers.1.weight"][:, :, 0].T
               + sd["last_conv_layers.1.bias"])
    return o @ sd["last_conv_layers.3.weight"][:, :, 0].T + sd["last_conv_layers.3.bias"]


def mol_nll(y_hat: torch.Tensor, y: torch.Tensor, log_scale_min: float,
            num_classes: int = 65536) -> torch.Tensor:
    """The mean over (B, T) of -log P(y) for y (B, T, 1) in [-1, 1] under the
    discretized mixture of logistics y_hat (B, T, 3K): logits, means, log
    scales (clamped below at ``log_scale_min``).  A bin is 2 / (classes - 1)
    wide; the lowest bin takes the CDF's lower tail, the highest its upper
    tail, and an inner bin with mass under 1e-5 takes the density at its
    centre times the bin's width."""
    k = y_hat.shape[-1] // 3
    logits, mu = y_hat[..., :k], y_hat[..., k:2 * k]
    log_s = y_hat[..., 2 * k:].clamp(min=log_scale_min)
    half_bin = 1.0 / (num_classes - 1)
    inv_s = torch.exp(-log_s)
    z = y - mu
    upper, lower = inv_s * (z + half_bin), inv_s * (z - half_bin)
    lower_tail = F.logsigmoid(upper)                  # log P(X < y + half a bin)
    upper_tail = F.logsigmoid(-lower)                 # log P(X > y - half a bin)
    mass = torch.sigmoid(upper) - torch.sigmoid(lower)
    centre = inv_s * z
    log_density = F.logsigmoid(centre) + F.logsigmoid(-centre) - log_s
    inner = torch.where(mass > 1e-5, torch.log(mass.clamp(min=1e-12)),
                        log_density + math.log(2.0 * half_bin))
    log_p = torch.where(y < -0.999, lower_tail, torch.where(y > 0.999, upper_tail, inner))
    return -torch.logsumexp(log_p + torch.log_softmax(logits, -1), -1).mean()


def step_loss(sd: dict, voc: dict, x: torch.Tensor, frames: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """The step's loss: step t's mixture predicts sample t + 1."""
    y_hat = forward(sd, voc, x, frames, generator)
    return mol_nll(y_hat[:, :-1], x[:, 1:], voc["log_scale_min"])


def ema_decay(t: int) -> float:
    """The trail's decay after ``t`` steps: the ramp min(0.9999, (1 + t) /
    (10 + t)), so that a short run's trail is not mostly its start."""
    return min(EMA_DECAY, (1.0 + t) / (10.0 + t))


def train(sd: dict, voc: dict, batches: list, lr: float, device, tf32: bool = False) -> dict:
    """Train from the state dict ``sd`` on ``batches``, a list of (x (B, T,
    1), frames (B, T // hop, C), the state of the generator that the step's
    dropout is drawn from, or None for none).  Returns each step's
    ``losses``, the first step's gradients (``grads1``), and the
    ``params`` and the trail ``ema`` after the last step.  The last
    layer's residual product feeds nothing: its gradient is zero, and
    Adam leaves it where it was."""
    set_tf32(tf32)
    try:
        params = {k: v.detach().to(device=device, dtype=torch.float32).clone().requires_grad_()
                  for k, v in sd.items()}
        ema = {k: p.detach().clone() for k, p in params.items()}
        opt = Adam(params, lr)
        losses, grads1 = [], None
        for t, (x, frames, state) in enumerate(batches):
            gen = None
            if state is not None:
                gen = torch.Generator(device=device)
                gen.set_state(state)
            loss = step_loss(params, voc, x.to(device), frames.to(device), gen)
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), got)}
            if grads1 is None:
                grads1 = grads
            opt.step(params, grads)
            d = ema_decay(t)
            with torch.no_grad():
                for k, e in ema.items():
                    e.mul_(d).add_(params[k], alpha=1.0 - d)
            losses.append(loss.item())
    finally:
        set_tf32(False)
    return {"losses": losses, "grads1": grads1,
            "params": {k: p.detach() for k, p in params.items()}, "ema": ema}
