"""The adversarial content regularizer and remat of the port against dvc_tpu
on the CPU, at the tiny widths of tests/test_train.py: grad_reverse, one
adversarial train step in each mode (the loss terms, both nets' gradients
and updated parameters, adv_ce and adv_acc), the z-score's population std,
the remat step (against the plain step and against dvc_tpu's remat step,
the BatchNorm statistics moved once), the Trainer's guards, and
`train --adv_cof` through the CLI with dvc_tpu's `convert` on its run,
and the config.json of both packages' `train` (equal as text).

The same seeded numpy inputs and weights go to both packages (the
adversary's through adversary_state_dict_from_jax); dvc_tpu's noise is
injected as in test_torch_port_train.py."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from dvc_tpu.cli import run as jcli
from dvc_tpu.train.adversarial import AdvState, create_adv_state
from dvc_tpu.train.adversarial import grad_reverse as jax_grad_reverse
from dvc_tpu.train.adversarial import make_adv_train_step as jax_make_adv_train_step
from dvc_tpu.train.trainer import TrainState
from dvc_tpu.train.trainer import make_train_step as jax_make_train_step
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import LossConfig
from dvc_tpu_torch.train import adversarial
from dvc_tpu_torch.train.trainer import Trainer, _step_seed, make_optimizer, make_train_step
from dvc_tpu_torch.utils.convert import adversary_state_dict_from_jax, vae_state_dict_from_jax
from test_torch_port_train import (B, GRAD_RTOL, PRE_BN_BIAS_SHARE, SMALL, STATS_ATOL,
                                   TERM_RTOL, _batch, _grab_grads, _injector, _is_pre_bn_bias,
                                   _jax_vae, _mel_tree, _np_tree, _port_vae, tiny_config)

N_SPK = 3
SPK = np.array([0, 2, 1, 2], np.int32)
VAE_LR, ADV_LR = 1e-4, 1e-3
# large enough that the adversary's gradient through the encoder is of the
# size of the VAE loss's (the tiny VAE's loss is ~4e4 at init)
ADV_COF = 1e3
# updated parameters, max |diff| over the parameter's max |p|, where the
# reference gradient is resolved (above GRAD_RTOL of its max): Adam's first
# step is lr * g / (|g| + eps), +-lr wherever |g| >> eps, so an element
# whose gradient is rounding noise may step either way; there the step is
# held to its size, lr
PARAM_RTOL = 1e-3
# remat against the plain step in the port: the same arithmetic, recomputed
REMAT_ATOL = 1e-6


def _jax_adversary():
    am, st, _ = create_adv_state(jax.random.PRNGKey(2), 28, N_SPK)
    return am, st.params


def _port_adversary(params):
    adv = adversarial.SpeakerAdversary(28, N_SPK)
    adv.load_state_dict(adversary_state_dict_from_jax(_np_tree(params)))
    return adv


def _adam_applied(params, grads, lr):
    """dvc_tpu's optax.adam(lr) first update of params by grads."""
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    upd, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, upd)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _check_updates(params, sd0, ref_g, ref_p, lr, skip=lambda name: False):
    """Each parameter's Adam step is at most lr; unless skip (a gradient
    that is all rounding noise), its gradient is held to dvc_tpu's and its
    update too, where the reference gradient is resolved."""
    for name, p in params:
        g, w = p.grad.numpy(), ref_g[name].numpy()
        new, old = p.detach().numpy(), sd0[name].numpy()
        # the step, plus the float32 rounding of the parameter it moved
        assert np.abs(new - old).max() <= lr * (1 + 1e-6) + np.spacing(np.abs(old).max()), name
        if skip(name):
            continue
        assert _rel(g, w) <= GRAD_RTOL, (name, _rel(g, w))
        sure = np.abs(w) > GRAD_RTOL * np.abs(w).max()
        err = np.abs(new - ref_p[name].numpy())[sure]
        assert err.size == 0 or err.max() <= PARAM_RTOL * np.abs(ref_p[name].numpy()).max(), name


def _check_nets(pm, adv, v_grads, v_params, a_grads, a_params):
    """Both nets' gradients and Adam-updated parameters against dvc_tpu's
    (the grads as its step handed them to the optimizer)."""
    ref_g = vae_state_dict_from_jax(_np_tree(v_grads), None)
    for name, p in pm.named_parameters():
        if _is_pre_bn_bias(name):  # exact gradient 0: rounding noise on both sides
            g, w = p.grad.numpy(), ref_g[name].numpy()
            w_max = np.abs(ref_g[name[:-len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= PRE_BN_BIAS_SHARE * w_max, name
    _check_updates(pm.named_parameters(), vae_state_dict_from_jax(_np_tree(v_params), None),
                   ref_g, vae_state_dict_from_jax(
                       _np_tree(_adam_applied(v_params, v_grads, VAE_LR)), None),
                   VAE_LR, skip=_is_pre_bn_bias)
    _check_updates(adv.named_parameters(), adversary_state_dict_from_jax(_np_tree(a_params)),
                   adversary_state_dict_from_jax(_np_tree(a_grads)),
                   adversary_state_dict_from_jax(
                       _np_tree(_adam_applied(a_params, a_grads, ADV_LR))), ADV_LR)


# -- grad_reverse ----------------------------------------------------------------

@pytest.mark.parametrize("lam", [1.0, 0.5])
def test_grad_reverse(lam):
    """Identity forward; the backward is -lam * g, as dvc_tpu's custom_vjp."""
    x0 = np.array([[1.0, -2.0, 0.5], [3.0, 0.0, -1.5]], np.float32)
    x = torch.from_numpy(x0).requires_grad_()
    y = adversarial.grad_reverse(x, lam)
    assert torch.equal(y, x)
    (y ** 2).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax_grad_reverse(a, lam) ** 2))(jnp.asarray(x0))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), -lam * 2 * x0, rtol=1e-7)


# -- one adversarial step --------------------------------------------------------

def _jax_adv_step(mode, x1, x2, eps):
    jm, v = _jax_vae(True)
    am, a_params = _jax_adversary()
    opt = _grab_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    adv_state = AdvState(params=a_params, opt_state=opt.init(a_params))
    icpt, calls = _injector(eps)
    with fnn.intercept_methods(icpt):
        new, new_adv, terms, m = jax_make_adv_train_step(
            jm, opt, am, opt, adv_cof=ADV_COF, mode=mode, compute_dtype="float32",
            jit=False)(state, adv_state, jnp.asarray(x1), jnp.asarray(x2),
                       jnp.asarray(SPK), jax.random.PRNGKey(0))
    assert len(calls) == 3
    return v, a_params, new, new_adv, terms, m


def _port_adv_step(v, a_params, mode, x1, x2, eps):
    pm = _port_vae(v, True)
    adv = _port_adversary(a_params)
    step = adversarial.make_adv_train_step(
        pm, make_optimizer(pm, VAE_LR), adv, make_optimizer(adv, ADV_LR), adv_cof=ADV_COF,
        mode=mode, compute_dtype="float32")
    terms, m = step(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(SPK),
                    eps=tuple(torch.from_numpy(e) for e in eps))
    return pm, adv, terms, m


@pytest.mark.parametrize("mode", ["confusion", "grl"])
def test_adv_step(mode):
    """One step from the same VAE, adversary, batch and noise against
    dvc_tpu's make_adv_train_step(jit=False): the eight loss terms, adv_ce
    and adv_acc, both nets' gradients and updated parameters, and the new
    BatchNorm statistics."""
    x1, x2, eps = _batch(7)
    v, a_params, new, new_adv, want, wm = _jax_adv_step(mode, x1, x2, eps)
    pm, adv, got, gm = _port_adv_step(v, a_params, mode, x1, x2, eps)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_allclose(g.item(), float(w), rtol=TERM_RTOL, err_msg=name)
    np.testing.assert_allclose(gm["adv_ce"].item(), float(wm["adv_ce"]), rtol=TERM_RTOL)
    assert gm["adv_acc"].item() == float(wm["adv_acc"])
    _check_nets(pm, adv, new.opt_state, v["params"], new_adv.opt_state, a_params)
    stats = vae_state_dict_from_jax(_np_tree(v["params"]), _np_tree(new.batch_stats))
    for name, buf in pm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=STATS_ATOL,
                                       err_msg=name)


def test_zscore_population_std(monkeypatch):
    """The confusion mode z-scores with the population std (jnp.std, ddof
    0); on this batch of 2B = 8 latents a sample std (ddof 1, torch's
    default) moves adv_ce outside the check's limit."""
    x1, x2, eps = _batch(8)
    v, a_params, _, _, _, wm = _jax_adv_step("confusion", x1, x2, eps)
    _, _, _, gm = _port_adv_step(v, a_params, "confusion", x1, x2, eps)
    np.testing.assert_allclose(gm["adv_ce"].item(), float(wm["adv_ce"]), rtol=TERM_RTOL)
    monkeypatch.setattr(adversarial, "zscore", lambda z, group=None:
                        (z - z.mean(0, keepdim=True)) / (z.std(0, keepdim=True) + 1e-5))
    _, _, _, bad = _port_adv_step(v, a_params, "confusion", x1, x2, eps)
    err = abs(bad["adv_ce"].item() - float(wm["adv_ce"])) / float(wm["adv_ce"])
    assert err > 10 * TERM_RTOL, err


def test_bad_mode_rejected():
    pm = _port_vae(_jax_vae(True)[1], True)
    adv = adversarial.SpeakerAdversary(28, N_SPK)
    with pytest.raises(ValueError, match="mode must be"):
        adversarial.make_adv_train_step(pm, make_optimizer(pm, 1e-4), adv,
                                        make_optimizer(adv, 1e-3), mode="dann")


# -- remat ---------------------------------------------------------------------------

def test_remat_step_equals_plain_step():
    """remat recomputes the forward in the backward: the same loss terms,
    gradients and updated weights as the plain step, with the noise from
    the same generator, and each BatchNorm's running statistics moved once
    (one batch counted, the plain step's values)."""
    _, v = _jax_vae(True)
    x1, x2 = (torch.from_numpy(a) for a in _batch(9)[:2])
    runs = []
    for remat in (False, True):
        pm = _port_vae(v, True)
        terms = make_train_step(pm, make_optimizer(pm, VAE_LR), compute_dtype="float32",
                                remat=remat)(x1, x2, generator=torch.Generator().manual_seed(5))
        runs.append((terms, pm))
    (t_plain, plain), (t_remat, remat) = runs
    for a, b in zip(t_plain, t_remat):
        np.testing.assert_allclose(b.item(), a.item(), rtol=REMAT_ATOL)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), atol=REMAT_ATOL, err_msg=name)
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), atol=REMAT_ATOL)
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        if "num_batches_tracked" in name:
            assert a.item() == b.item() == 1, name
        else:
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=REMAT_ATOL, err_msg=name)


def test_remat_step_against_dvc_tpu():
    """The port's remat step against dvc_tpu's make_train_step(remat=True):
    loss terms, gradients and the new BatchNorm statistics, at
    test_torch_port_train.py's limits."""
    jm, v = _jax_vae(True)
    x1, x2, eps = _batch(10)
    opt = _grab_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    icpt, calls = _injector(eps)
    with fnn.intercept_methods(icpt):
        new, want = jax_make_train_step(jm, opt, compute_dtype="float32", jit=False,
                                        remat=True)(state, jnp.asarray(x1), jnp.asarray(x2),
                                                    jax.random.PRNGKey(0))
    pm = _port_vae(v, True)
    got = make_train_step(pm, make_optimizer(pm, VAE_LR), compute_dtype="float32", remat=True)(
        torch.from_numpy(x1), torch.from_numpy(x2), eps=tuple(torch.from_numpy(e) for e in eps))
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_allclose(g.item(), float(w), rtol=TERM_RTOL, err_msg=name)
    ref = vae_state_dict_from_jax(_np_tree(new.opt_state), _np_tree(new.batch_stats))
    for name, p in pm.named_parameters():
        g, w = p.grad.numpy(), ref[name].numpy()
        if _is_pre_bn_bias(name):
            w_max = np.abs(ref[name[:-len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= PRE_BN_BIAS_SHARE * w_max, name
            continue
        assert _rel(g, w) <= GRAD_RTOL, (name, _rel(g, w))
    for name, buf in pm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(), atol=STATS_ATOL,
                                       err_msg=name)


# -- the Trainer -----------------------------------------------------------------------

def test_trainer_adversary_guards():
    """adv_cof > 0 needs the speaker count; adv_cof = 0 builds no adversary
    and trains bit for bit as make_train_step does; adv_cof > 0 with remat
    trains and reports adv_ce and adv_acc."""
    cfg = tiny_config(batch_size=B)
    with pytest.raises(ValueError, match="adv_speakers"):
        Trainer(cfg.replace(loss=LossConfig(adv_cof=1.0)), device="cpu")
    tr = Trainer(cfg, device="cpu")
    assert tr.adversary is None
    ref = Trainer(cfg, device="cpu")
    step = make_train_step(ref.model, ref.optimizer, compute_dtype="float32")
    x1, x2 = (torch.from_numpy(a) for a in _batch(11)[:2])
    a = tr.step_on(x1, x2)
    b = step(x1, x2, generator=torch.Generator().manual_seed(_step_seed(cfg.train.seed + 1, 0)))
    assert all(torch.equal(p, q) for p, q in zip(a, b)) and tr.adv_metrics == {}
    for p, q in zip(tr.model.parameters(), ref.model.parameters()):
        assert torch.equal(p, q)
    adv_cfg = cfg.replace(loss=LossConfig(adv_cof=1.0, adv_speakers=N_SPK),
                          train=dataclasses.replace(cfg.train, remat=True))
    tr = Trainer(adv_cfg, device="cpu")
    terms = tr.step_on(x1, x2, torch.from_numpy(SPK).long())
    assert np.isfinite(terms.total.item())
    assert set(tr.adv_metrics) == {"adv_ce", "adv_acc"}
    assert 0.0 <= tr.adv_metrics["adv_acc"].item() <= 1.0


def test_cli_train_adv_then_dvc_tpu_convert(tmp_path, monkeypatch, capsys):
    """`train --adv_cof 1 --adv_mode grl` on the CPU: finite losses, the
    adversary's TensorBoard scalars, config.json with the speaker count, the
    estimation PNGs, and checkpoints that dvc_tpu's `convert` loads."""
    _mel_tree(str(tmp_path / "mels"), speakers=("p225", "p226", "p227"), utts=4,
              t_range=(20, 40))

    def small(real):
        def config(args):
            cfg = real(args)
            widths = {k: v for k, v in SMALL.items() if k != "frames"}
            return cfg.replace(vae=dataclasses.replace(cfg.vae, **widths))
        return config

    monkeypatch.setattr(cli, "_config_from_args", small(cli._config_from_args))
    monkeypatch.setattr(jcli, "_config_from_args", small(jcli._config_from_args))
    run = tmp_path / "run"
    common = ["--dataset_fp", str(tmp_path / "mels"), "--log_dir", str(run),
              "--samples_length", "16"]
    assert cli.main(["train", *common, "--epochs", "2", "--report-interval", "2",
                     "--batch-size", "2", "--compute-dtype", "float32", "--adv_cof", "1",
                     "--adv_mode", "grl", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in out.splitlines() if "Epoch" in ln]
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    loss_cfg = json.loads((run / "config.json").read_text())["loss"]
    assert (loss_cfg["adv_cof"], loss_cfg["adv_speakers"], loss_cfg["adv_mode"]) == (1.0, 3, "grl")
    assert sorted(os.listdir(run / "checkpoints")) == [
        f"DisentangledVAE_VCTK_2{s}" for s in (".msgpack", ".opt.pth", ".pth")]
    events = b"".join(p.read_bytes() for p in (run / "logs" / "DisentangledVAE_VCTK").iterdir())
    assert b"Loss\\Adversary CE" in events and b"Loss\\Adversary Acc" in events
    est = run / "images" / "estimation"
    assert sorted(os.listdir(est)) == sorted(f"2_{k}_mel_{i}.png" for k in ("original", "recons")
                                             for i in range(2))
    assert jcli.main(["convert", *common, "--src_spk", "p225", "--trg_spk", "p226",
                      "--num_utterances", "1", "--vocoder", "none"]) == 0
    assert "loaded checkpoint at epoch 2" in capsys.readouterr().out


def test_config_json_equals_dvc_tpus():
    """The port's Config serializes as dvc_tpu's, as text: the same fields
    in the same order with the same defaults."""
    from dvc_tpu.config import Config as JaxConfig
    from dvc_tpu_torch.config import Config
    assert Config().to_json() == JaxConfig().to_json()


class _StopAfterConfig(Exception):
    pass


def _stop(*args, **kwargs):
    raise _StopAfterConfig


@pytest.mark.parametrize("flags", [
    [],
    ["--adv_cof", "1", "--adv_mode", "grl", "--lr", "3e-4", "--latent-size", "16",
     "--speaker_size", "2", "--checkpoint-format", "msgpack"],
], ids=["defaults", "adv-and-widths"])
def test_cli_train_config_json_equals_dvc_tpus(tmp_path, monkeypatch, flags):
    """`train` writes the config.json that dvc_tpu's `train` writes for the
    same flags, byte for byte (each stopped right after writing it, before
    its Trainer is built); the adversary's width is the corpus's speakers."""
    import dvc_tpu.train.trainer as jtrainer
    import dvc_tpu_torch.train.trainer as ptrainer
    _mel_tree(str(tmp_path / "mels"), speakers=("p225", "p226", "p227"), utts=4,
              t_range=(20, 40))
    monkeypatch.setattr(ptrainer, "Trainer", _stop)
    monkeypatch.setattr(jtrainer, "Trainer", _stop)
    texts = []
    for main, name in ((cli.main, "port"), (jcli.main, "jax")):
        run = tmp_path / name
        args = ["train", "--dataset_fp", str(tmp_path / "mels"), "--log_dir", str(run),
                "--samples_length", "16", "--batch-size", "2", "--epochs", "3", *flags]
        with pytest.raises(_StopAfterConfig):
            main(args + (["--device", "cpu"] if name == "port" else []))
        texts.append((run / "config.json").read_text())
    assert texts[0] == texts[1]
    cfg = json.loads(texts[0])
    assert cfg["train"]["donate_state"] is True and cfg["mesh"]["data_parallel"] == -1
    if flags:
        assert (cfg["loss"]["adv_speakers"], cfg["vae"]["latent_dim"]) == (3, 16)
