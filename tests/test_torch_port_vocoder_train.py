"""The WaveNet vocoder's training in the port against dvc_tpu on the CPU, at
a small width: the MoL NLL on all three of its branches, the train-mode
forward, the layer-input dropout, one train step, Adam with the EMA
warm-up, wav_batches, and the saved EMA checkpoint read both ways.

The same seeded numpy inputs and weights (through utils/convert) go to
both packages.  JAX's dropout stream is not torch's, so parity holds at
dropout 0 and dropout is tested on its own."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.convert import vocode as jvocode
from dvc_tpu.models import wavenet as jwn
from dvc_tpu.train import vocoder_trainer as jvt
from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.convert.vocode import load_vocoder_params
from dvc_tpu_torch.models import wavenet as pwn
from dvc_tpu_torch.train import vocoder_trainer as pvt
from dvc_tpu_torch.train.trainer import _step_seed, make_optimizer
from dvc_tpu_torch.utils.convert import (wavenet_state_dict_from_jax,
                                         wavenet_tree_from_state_dict)
from dvc_tpu_torch.utils.wavio import write_wav

SMALL = dict(layers=4, stacks=2, residual_channels=32, gate_channels=32,
             skip_out_channels=16)
B, T = 2, 1024
# the per-layer gate of tests/test_torch_parity.py:27
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
# the step limits of tests/test_torch_port_train.py: the loss, and each
# gradient's max |diff| over its max |g|
TERM_RTOL, GRAD_RTOL = 1e-5, 1e-3
# the MoL NLL elementwise: float32 transcendentals in another library
MOL_RTOL, MOL_ATOL = 1e-5, 1e-4


def _cfgs(**kw):
    return JC.VocoderConfig(**SMALL, **kw), VocoderConfig(**SMALL, **kw)


def _jax_params(jcfg, seed=0):
    model = jwn.WaveNet(jcfg)
    hop = int(np.prod(jcfg.upsample_scales))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4 * hop, 1)),
                        jnp.zeros((1, 4, jcfg.cin_channels)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(pcfg, params):
    m = pwn.WaveNet(pcfg)
    m.load_state_dict(wavenet_state_dict_from_jax(params))
    return m


def _batch(seed=0, t=T):
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(B, t, 1) * 0.3, -1, 1).astype(np.float32)
    c = rng.rand(B, t // 256, 80).astype(np.float32)
    return x, c


# -- the MoL NLL ---------------------------------------------------------------

def _mol_inputs():
    """y_hat and y that reach every branch: y at both edges, bins with mass
    above 1e-5, and bins below it (wide or far-off logistics), where the
    density at the centre stands in."""
    rng = np.random.RandomState(3)
    n, k = 512, 10
    logits = rng.randn(2, n, k)
    means = rng.uniform(-1, 1, (2, n, k))
    log_scales = rng.uniform(-9.0, 3.0, (2, n, k))
    y_hat = np.concatenate([logits, means, log_scales], -1).astype(np.float32)
    y = rng.uniform(-1, 1, (2, n, 1))
    y[:, :40] = -1.0
    y[:, 40:80] = 1.0
    y[:, 80:100] = rng.uniform(-0.9995, -0.999, (2, 20, 1))  # just inside the edge
    return y_hat, y.astype(np.float32)


def _bin_rounding(y_hat, y):
    """Per (b, t, mixture): the float32 rounding of a bin's mass relative to
    the mass, 2^-24 (cdf_plus + cdf_min) / cdf_delta, where the bin branch
    is taken, else 0; computed in float64.  cdf_delta is a difference of two
    sigmoids, so where the bin is narrow against the logistic this
    cancellation, not the code, sets how far two float32 libraries (XLA's
    exp and torch's differ by an ulp on some of these inputs) agree."""
    nr = y_hat.shape[-1] // 3
    yh, y = y_hat.astype(np.float64), y.astype(np.float64)
    inv = np.exp(-np.maximum(yh[..., 2 * nr:], -32.23619130191664))
    cen = y - yh[..., nr:2 * nr]
    sig = lambda v: 0.5 * (1 + np.tanh(v / 2))  # noqa: E731
    sp, sm = sig(inv * (cen + 1 / 65535)), sig(inv * (cen - 1 / 65535))
    delta = sp - sm
    binned = (delta > 1e-5) & (np.abs(y) <= 0.999)
    return np.where(binned, 2.0 ** -24 * (sp + sm) / np.maximum(delta, 1e-300), 0.0), \
        binned, delta


def test_mol_loss_matches_dvc_tpu_on_every_branch():
    """Elementwise within 1e-5 relative and 1e-4 absolute plus 4 kappa, kappa
    the posterior-weighted float32 rounding of the element's bin masses
    (_bin_rounding; 0 on the edge and tail branches, up to ~1e-2 where a
    bin holds 1e-5 of a logistic centred near it); the mean within 1e-5;
    the gradient within 1e-5 of its max plus 4 kappa of its row's max."""
    y_hat, y = _mol_inputs()
    rel, binned, delta = _bin_rounding(y_hat, y)
    edge = np.abs(y[..., 0]) > 0.999
    assert (y < -0.999).sum() >= 40 and (y > 0.999).sum() >= 40
    assert binned.sum() > 500
    assert ((delta <= 1e-5) & ~edge[..., None]).sum() > 500

    want = np.asarray(jwn.discretized_mix_logistic_loss(jnp.asarray(y_hat), jnp.asarray(y),
                                                        reduce=False))
    got = pwn.discretized_mix_logistic_loss(torch.from_numpy(y_hat), torch.from_numpy(y),
                                            reduce=False).numpy()
    assert got.shape == want.shape == (2, 512)
    # each mixture's share of the element's likelihood (float64)
    lp = np.where(binned, np.log(np.maximum(delta, 1e-300)), -50.0) + y_hat[..., :10] \
        - np.log(np.exp(y_hat[..., :10].astype(np.float64)).sum(-1, keepdims=True))
    w = np.exp(lp - lp.max(-1, keepdims=True))
    kappa = (w / w.sum(-1, keepdims=True) * rel).sum(-1)
    assert (kappa == 0).sum() > 200  # edges and tails: the plain limits
    err = np.abs(got - want)
    assert (err <= MOL_ATOL + MOL_RTOL * np.abs(want) + 4 * kappa).all(), \
        (err / (MOL_ATOL + MOL_RTOL * np.abs(want) + 4 * kappa)).max()

    jmean = float(jwn.discretized_mix_logistic_loss(jnp.asarray(y_hat), jnp.asarray(y)))
    yh = torch.from_numpy(y_hat).requires_grad_()
    mean = pwn.discretized_mix_logistic_loss(yh, torch.from_numpy(y))
    assert abs(mean.item() - jmean) <= 1e-5 * abs(jmean)
    mean.backward()
    jgrad = np.asarray(jax.grad(lambda a: jwn.discretized_mix_logistic_loss(
        a, jnp.asarray(y)))(jnp.asarray(y_hat)))
    gerr = np.abs(yh.grad.numpy() - jgrad).max(-1)
    bound = 1e-5 * np.abs(jgrad).max() + 4 * rel.max(-1) * np.abs(jgrad).max(-1)
    assert (gerr <= bound).all(), (gerr / bound).max()


# -- the train-mode forward and dropout ------------------------------------------

def test_train_forward_matches_dvc_tpu_at_dropout_0():
    jcfg, pcfg = _cfgs(dropout=0.0)
    jm, params = _jax_params(jcfg)
    x, c = _batch()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(c),
                               train=True, rngs={"dropout": jax.random.PRNGKey(1)}))
    got = _port_model(pcfg, params)(torch.from_numpy(x), torch.from_numpy(c), train=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_RTOL, atol=FWD_ATOL)


def _forward_before_dropout(model, x, c):
    """The port's teacher-forced forward as it was before dropout existed
    (no train flag), written out layer by layer."""
    c = model.upsample(c).transpose(1, 2)
    h = model.first_conv(x.transpose(1, 2))
    skips = None
    for layer in model.conv_layers:
        a, g = (layer.conv(torch.nn.functional.pad(h, (layer.pad, 0)))
                + layer.conv1x1c(c)).chunk(2, dim=1)
        out = torch.tanh(a) * torch.sigmoid(g)
        h, s = (layer.conv1x1_out(out) + h) * pwn.SQRT_HALF, layer.conv1x1_skip(out)
        skips = s if skips is None else (skips + s) * pwn.SQRT_HALF
    out = torch.relu(model.last_conv_layers[1](torch.relu(skips)))
    return model.last_conv_layers[3](out).transpose(1, 2)


def test_inference_is_unchanged_and_draws_nothing():
    """train=False (the default) is bit for bit the forward before dropout,
    whatever cfg.dropout, and leaves torch's RNG untouched."""
    _, pcfg = _cfgs()
    assert pcfg.dropout == 1 - 0.95
    model = pvt.create_wavenet(pcfg, seed=4, device="cpu")
    x, c = (torch.from_numpy(a) for a in _batch(1))
    state = torch.random.get_rng_state()
    with torch.no_grad():
        got = model(x, c)
        assert torch.equal(got, model(x, c, train=False))
        assert torch.equal(got, _forward_before_dropout(model, x, c))
    assert torch.equal(state, torch.random.get_rng_state())


def _captured_conv_input(cfg, x, generator):
    """Layer 0 of a WaveNet in train mode: (x, the input its dilated conv
    received, the residual output with conv1x1_out zeroed)."""
    model = pvt.create_wavenet(cfg, seed=5, device="cpu")
    layer = model.conv_layers[0]
    with torch.no_grad():
        layer.conv1x1_out.weight.zero_()
        layer.conv1x1_out.bias.zero_()
    seen = []
    layer.conv.register_forward_pre_hook(lambda m, a: seen.append(a[0][..., layer.pad:]))
    c = torch.rand(x.shape[0], cfg.cin_channels, x.shape[-1])
    with torch.no_grad():
        res, _ = layer(x, c, 1.0 - cfg.dropout, generator)
    return seen[0], res


def test_dropout_mask_scale_residual_and_seed():
    _, pcfg = _cfgs()
    x = torch.randn(4, pcfg.residual_channels, 2048)
    gen = torch.Generator().manual_seed(_step_seed(1, 7))
    conv_in, res = _captured_conv_input(pcfg, x, gen)
    keep = 1.0 - pcfg.dropout
    kept = conv_in != 0
    n = x.numel()
    share = kept.float().mean().item()
    # binomial(n, 0.95): within 5 standard deviations
    assert abs(share - 0.95) <= 5 * math.sqrt(0.95 * 0.05 / n), share
    # the kept values are x / 0.95, the dropped ones 0
    np.testing.assert_allclose(conv_in[kept].numpy(), (x[kept] / 0.95).numpy(), rtol=1e-6)
    assert torch.equal(conv_in, torch.where(kept, x / keep, torch.zeros(())))
    # the residual takes the undropped x
    assert torch.equal(res, x * pwn.SQRT_HALF)
    # the same (seed, step) draws the same mask; the next step another
    again, _ = _captured_conv_input(pcfg, x, torch.Generator().manual_seed(_step_seed(1, 7)))
    other, _ = _captured_conv_input(pcfg, x, torch.Generator().manual_seed(_step_seed(1, 8)))
    assert torch.equal(again, conv_in)
    assert not torch.equal(other != 0, kept)


def test_trainer_steps_repeat_per_seed_and_step():
    """Two trainers from one seed take bit-equal steps; the step's dropout
    depends on the step count, so a trainer moved to step 3 draws what a
    straight run draws at its fourth step."""
    _, pcfg = _cfgs()
    x, c = (torch.from_numpy(a) for a in _batch(2))
    a, b = (pvt.VocoderTrainer(pcfg, device="cpu") for _ in range(2))
    la = [a.step_on(x, c).item() for _ in range(2)]
    lb = [b.step_on(x, c).item() for _ in range(2)]
    assert la == lb
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n
    y1 = pvt.VocoderTrainer(pcfg, device="cpu")
    y2 = pvt.VocoderTrainer(pcfg, device="cpu")
    y2.step = 3
    g1 = torch.Generator().manual_seed(_step_seed(1, 3))
    with torch.no_grad():
        want = y1.model(x, c, train=True, generator=g1)
    y2._gen.manual_seed(_step_seed(y2.seed + 1, y2.step))
    with torch.no_grad():
        assert torch.equal(y2.model(x, c, train=True, generator=y2._gen), want)


# -- one train step, Adam and the EMA ---------------------------------------------

def test_train_step_matches_make_wavenet_step():
    """One step of dvc_tpu's make_wavenet_step and of the port's from the
    same weights and batch, at dropout 0: the NLL, and each gradient (read
    back from optax's first moment, mu = 0.1 g after one step)."""
    jcfg, pcfg = _cfgs(dropout=0.0)
    jmodel, jstate, jopt = jvt.create_wavenet_state(jax.random.PRNGKey(0), jcfg,
                                                    max_time_steps=T)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jvt.make_wavenet_step(jmodel, jopt, jcfg)
    x, c = _batch(6)
    jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(c), jax.random.PRNGKey(1))
    jgrads = wavenet_state_dict_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / np.float32(0.1), jstate.opt_state[0].mu))

    model = _port_model(pcfg, params).train()
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = pvt.make_wavenet_step(model, make_optimizer(model, 1e-3), ema, pcfg)
    loss = step(torch.from_numpy(x), torch.from_numpy(c), 0)
    assert abs(loss.item() - float(jloss)) <= TERM_RTOL * abs(float(jloss))
    for n, p in model.named_parameters():
        want = jgrads[n]
        if not want.any():  # the last layer's residual output feeds nothing
            assert n.startswith(f"conv_layers.{pcfg.layers - 1}.conv1x1_out"), n
            assert p.grad is None or not p.grad.any(), n
            continue
        err = (p.grad - want).abs().max().item() / want.abs().max().item()
        assert err <= GRAD_RTOL, (n, err)
    assert int(jstate.step) == 1


def test_adam_and_ema_warmup_match_optax_and_the_formula():
    """Fed gradients, three steps: torch's Adam against dvc_tpu's
    optax.adam(1e-3, 0.9, 0.999, 1e-8), and the EMA trail against
    d e + (1 - d) p with d = min(0.9999, (1 + t) / (10 + t)) (dvc_tpu's
    make_wavenet_step, in float32)."""
    rng = np.random.RandomState(6)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * s for s in (1.0, 1e-3, 30.0)]
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jp, js, je = jnp.asarray(p0), tx.init(jnp.asarray(p0)), jnp.asarray(p0)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(torch.nn.ParameterList([tp]), 1e-3)
    ema = {"w": tp.detach().clone()}
    assert ema["w"].data_ptr() != tp.data_ptr()
    for t, g in enumerate(grads):
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        d = jnp.minimum(0.9999, (1.0 + jnp.float32(t)) / (10.0 + jnp.float32(t)))
        je = d * je + (1.0 - d) * jp
        tp.grad = torch.from_numpy(g)
        opt.step()
        pvt.ema_update_(ema, {"w": tp.detach()}, t)
        assert pvt.ema_decay_at(t) == float(d)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ema["w"].numpy(), np.asarray(je), rtol=1e-6, atol=1e-6)
    assert pvt.ema_decay_at(10 ** 6) == np.float32(0.9999)


# -- wav_batches -------------------------------------------------------------------

@pytest.mark.parametrize("sr", [16000, 22050])
def test_wav_batches_match_dvc_tpu(tmp_path, sr):
    """The same wavs, crops and mels as dvc_tpu's wav_batches, draw for draw:
    x bit for bit at 16 kHz (within resample_poly's 2e-6 when resampled),
    c within 1e-5.  A wav shorter than the crop is dropped."""
    rng = np.random.RandomState(sr)
    d = tmp_path / "wavs" / "spk"
    d.mkdir(parents=True)
    for i, secs in enumerate((0.9, 1.3, 0.05)):
        n = int(sr * secs)
        write_wav(str(d / f"u{i}.wav"), (0.3 * np.sin(np.arange(n) * (0.05 + 0.01 * i))
                                         + 0.02 * rng.randn(n)).astype(np.float32), sr)
    jcfg, pcfg = _cfgs()
    jit = jvt.wav_batches(str(tmp_path / "wavs"), 3, 4000, jcfg, seed=5)
    pit = pvt.wav_batches(str(tmp_path / "wavs"), 3, 4000, pcfg, seed=5)
    for _ in range(3):
        (jx, jc), (px, pc) = next(jit), next(pit)
        assert px.shape == jx.shape == (3, 3840, 1) and pc.shape == jc.shape == (3, 15, 80)
        if sr == 16000:
            np.testing.assert_array_equal(px, jx)
        else:
            np.testing.assert_allclose(px, jx, rtol=0, atol=2e-6)
        np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-5)


# -- checkpoints both ways -----------------------------------------------------------

def test_saved_ema_is_flax_bytes_and_read_both_ways(tmp_path):
    """The port's save is byte for byte what dvc_tpu's VocoderTrainer.save
    writes for the same EMA trail and step; dvc_tpu's make_vocoder reads
    it, and the port reads dvc_tpu's."""
    jcfg, pcfg = _cfgs()
    x, c = _batch(7)
    tr = pvt.VocoderTrainer(pcfg, device="cpu")
    tr.train_steps(iter([(x, c)] * 2), 2, logging_func=lambda *a: None)
    path = tr.save(str(tmp_path / "port"))
    assert path.endswith("wavenet_step000000002.msgpack")

    jtr = jvt.VocoderTrainer(dataclasses.replace(jcfg, dropout=0.0), max_time_steps=T)
    jtr.train_steps(iter([(x, c)]), 1, logging_func=lambda *a: None)
    port_tree = wavenet_tree_from_state_dict(tr.ema)
    jtr.state = jtr.state.replace(
        step=jnp.asarray(2, jnp.int32),
        ema_params=jax.tree_util.tree_map(lambda _, b: jnp.asarray(b),
                                          jtr.state.ema_params, port_tree))
    jpath = jtr.save(str(tmp_path / "jax"))
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes({"params": jtr.state.ema_params})

    # dvc_tpu reads the port's file
    got = jvocode.load_vocoder_params(path, jcfg)["params"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), b), got, port_tree))
    assert callable(jvocode.make_vocoder(path, jcfg))
    # the port reads dvc_tpu's (its own trail, from its own step)
    jtr2 = jvt.VocoderTrainer(jcfg, max_time_steps=T)
    jtr2.train_steps(iter([(x, c)]), 1, logging_func=lambda *a: None)
    sd = load_vocoder_params(jtr2.save(str(tmp_path / "jax2")))
    model = pwn.WaveNet(pcfg)
    model.load_state_dict(sd)  # strict
    want = wavenet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jtr2.state.ema_params))
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
