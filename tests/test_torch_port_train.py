"""The training slice of the port against dvc_tpu on the CPU, at the tiny
widths of tests/test_train.py: grouped BatchNorm, the pairwise train
forward, the losses, one train step (loss terms, gradients, new BN running
statistics) for pair_fused on and off and both compute dtypes, Adam, the
paired dataset, checkpoints and resume, the Trainer's epochs and the
`train` -> `convert` CLI.

The same seeded numpy inputs and weights (through vae_state_dict_from_jax)
go to both packages.  dvc_tpu runs unmodified; its reparameterization noise
is replaced through flax.linen.intercept_methods on
DisentangledVAE._reparameterize (three calls: content1, content2, style),
and the port gets the same draws through ``eps``."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from dvc_tpu import config as JC
from dvc_tpu.data.dataset import PairedMelDataset as JaxPairedMelDataset
from dvc_tpu.models.disentangled_vae import DisentangledVAE as JaxVAE
from dvc_tpu.models.layers import _GroupedBN
from dvc_tpu.train import losses as jlosses
from dvc_tpu.train.trainer import TrainState
from dvc_tpu.train.trainer import make_train_step as jax_make_train_step
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import Config, TrainConfig, VAEConfig
from dvc_tpu_torch.data.dataset import PairedMelDataset, prefetch
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.models.layers import BatchNorm
from dvc_tpu_torch.train import checkpoint as ckpt
from dvc_tpu_torch.train import losses
from dvc_tpu_torch.train.trainer import (Trainer, make_optimizer, make_train_step,
                                         unported_settings)
from dvc_tpu_torch.utils.convert import vae_state_dict_from_jax

SMALL = dict(frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
             dec_lstm2_hidden=32, postnet_channels=32)
B = 4
# the full-VAE gate of tests/test_torch_parity.py:234-244: float32 sums in
# another order through 3 convs, 3 LSTMs and the postnet
FULL_RTOL, FULL_ATOL = 1e-3, 1e-4
# scalar loss terms: sums of ~5000 float32 terms in another order, ~1e-6
# measured
TERM_RTOL = 1e-5
# gradients, max |diff| over the parameter's max |g|: 7.5e-5 measured (the
# backward adds another sum order on top of the forward's)
GRAD_RTOL = 1e-3
# a conv bias ahead of a train-mode BatchNorm has a zero gradient in exact
# arithmetic (the batch mean is subtracted): both packages return rounding
# noise, held to be below this share of the same conv's weight gradient
# (5e-6 measured)
PRE_BN_BIAS_SHARE = 1e-4
# BN running statistics after one step: 1e-7 measured
STATS_ATOL = 1e-5
# BatchNorm alone, float32 means/variances over (B/g, T)
BN_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_vae(fused):
    jm = JaxVAE(JC.VAEConfig(**SMALL), pair_fused=fused)
    x = jnp.zeros((2, 80, SMALL["frames"]), jnp.float32)
    key = jax.random.PRNGKey(0)
    v = jm.init({"params": key, "reparam": key}, x, x, train=True)
    return jm, v


def _port_vae(v, fused):
    pm = DisentangledVAE(VAEConfig(**SMALL), pair_fused=fused)
    pm.load_state_dict(vae_state_dict_from_jax(_np_tree(v["params"]),
                                               _np_tree(v["batch_stats"])))
    return pm.train()


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(B, 80, SMALL["frames"]).astype(np.float32)
    x2 = rng.rand(B, 80, SMALL["frames"]).astype(np.float32)
    k = 32 - 4
    eps = [rng.randn(B, k).astype(np.float32), rng.randn(B, k).astype(np.float32),
           rng.randn(B, 4).astype(np.float32)]
    return x1, x2, eps


def _injector(eps):
    """An interceptor that feeds dvc_tpu's _reparameterize the given draws in
    call order; returns (interceptor, calls)."""
    calls = []

    def icpt(next_fun, args, kwargs, context):
        if context.method_name != "_reparameterize":
            return next_fun(*args, **kwargs)
        mu, logvar = args[0], args[1]
        train = kwargs["train"] if "train" in kwargs else args[2]
        e = jnp.asarray(eps[len(calls)])
        calls.append(context.module.name)
        return e * jnp.exp(0.5 * logvar) + mu if train else mu

    return icpt, calls


# -- grouped BatchNorm -------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_grouped_bn(groups):
    """Output and the running statistics after two train calls, against
    dvc_tpu's _GroupedBN (one moving-average update a call)."""
    rng = np.random.RandomState(groups)
    c, t = 6, 5
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    xs = [rng.randn(4, t, c).astype(np.float32) * 2 + 0.5 for _ in range(2)]
    jbn = _GroupedBN(groups=groups)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), False)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    pbn = BatchNorm(c, groups=groups).train()
    with torch.no_grad():
        pbn.weight.copy_(torch.from_numpy(scale))
        pbn.bias.copy_(torch.from_numpy(bias))
    for x in xs:
        want, mut = jbn.apply(v, jnp.asarray(x), False, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        with torch.no_grad():
            got = pbn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BN_ATOL)
    np.testing.assert_allclose(pbn.running_mean.numpy(),
                               np.asarray(v["batch_stats"]["mean"]), atol=BN_ATOL)
    np.testing.assert_allclose(pbn.running_var.numpy(),
                               np.asarray(v["batch_stats"]["var"]), atol=BN_ATOL)
    # eval mode normalizes by the running statistics, as dvc_tpu's
    want = jbn.apply(v, jnp.asarray(xs[0]), True)
    with torch.no_grad():
        got = pbn.eval()(torch.from_numpy(xs[0]).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BN_ATOL)


# -- the pairwise forward ----------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["pair_fused", "unfused"])
def test_pair_forward(fused):
    """Train mode: all ten outputs and the new BN statistics; eval mode
    (running statistics, the content means, z_style still sampled)."""
    jm, v = _jax_vae(fused)
    pm = _port_vae(v, fused)
    x1, x2, eps = _batch(1)
    for train in (True, False):
        icpt, calls = _injector(eps)
        with fnn.intercept_methods(icpt):
            if train:
                want, mut = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2), train=True,
                                     rngs={"reparam": jax.random.PRNGKey(9)},
                                     mutable=["batch_stats"])
            else:
                want = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2), train=False,
                                rngs={"reparam": jax.random.PRNGKey(9)})
        assert len(calls) == 3
        pm.train(train)
        with torch.no_grad():
            got = pm(torch.from_numpy(x1), torch.from_numpy(x2),
                     eps=tuple(torch.from_numpy(e) for e in eps))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=FULL_RTOL, atol=FULL_ATOL)
        if train:
            sd = vae_state_dict_from_jax(_np_tree(v["params"]),
                                         _np_tree(mut["batch_stats"]))
            for name, buf in pm.named_buffers():
                if "running" in name:
                    np.testing.assert_allclose(buf.numpy(), sd[name].numpy(),
                                               atol=STATS_ATOL, err_msg=name)
            # eval mode below reads the statistics this call moved
            v = {"params": v["params"], "batch_stats": mut["batch_stats"]}


def test_forward_noise_from_generator():
    """Without eps the draws come from the generator: the same seed gives
    the same outputs, another seed others; eval mode draws only z_style."""
    _, v = _jax_vae(True)
    pm = _port_vae(v, True).eval()
    x1, x2, _ = _batch(2)
    a, b, c = (pm(torch.from_numpy(x1), torch.from_numpy(x2),
                  generator=torch.Generator().manual_seed(s))[0] for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- losses ------------------------------------------------------------------

def test_gvae_pair_loss_and_kl_delta():
    rng = np.random.RandomState(3)
    x = [rng.rand(B, 80, 16).astype(np.float32) for _ in range(6)]
    lat = [(rng.randn(B, 32) * 0.5).astype(np.float32) for _ in range(4)]
    style = [(rng.randn(B, 4) * 0.5).astype(np.float32) for _ in range(2)]
    args = x + lat + style
    want = jlosses.gvae_pair_loss(*map(jnp.asarray, args), mse_cof=3.0, kl_cof=7.0)
    got = losses.gvae_pair_loss(*map(torch.from_numpy, args), mse_cof=3.0, kl_cof=7.0)
    assert losses.LossTerms._fields == jlosses.LossTerms._fields
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.item(), float(w), rtol=TERM_RTOL)
    # the style KL stays out of the total
    assert abs(got.total.item() - 3.0 * sum(t.item() for t in got[1:5])
               - 7.0 * (got.z1_kl.item() + got.z2_kl.item())) <= 1e-3
    for alpha in (0.95, 0.5):
        w = jlosses.kl_delta_vae(jnp.asarray(lat[0]), jnp.asarray(lat[1]), alpha)
        g = losses.kl_delta_vae(torch.from_numpy(lat[0]), torch.from_numpy(lat[1]), alpha)
        np.testing.assert_allclose(g.item(), float(w), rtol=TERM_RTOL)


# -- one train step ------------------------------------------------------------

def _grab_grads():
    """An optax transformation that applies nothing and keeps the gradients
    as its state: make_train_step runs unmodified and hands them back."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _is_pre_bn_bias(name):
    return name.endswith("conv.bias") or (name.startswith("dec_modules")
                                          and name.endswith(".0.bias"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False], ids=["pair_fused", "unfused"])
def test_train_step(fused, dtype):
    """One step from the same weights, batch and noise: the eight loss terms,
    every parameter's gradient and the new BN running statistics against
    dvc_tpu's make_train_step(..., jit=False)."""
    jm, v = _jax_vae(fused)
    x1, x2, eps = _batch(4)
    opt = _grab_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    icpt, calls = _injector(eps)
    with fnn.intercept_methods(icpt):
        new, want = jax_make_train_step(jm, opt, compute_dtype=dtype, jit=False)(
            state, jnp.asarray(x1), jnp.asarray(x2), jax.random.PRNGKey(0))
    assert len(calls) == 3

    pm = _port_vae(v, fused)
    step = make_train_step(pm, make_optimizer(pm, 1e-4), compute_dtype=dtype)
    got = step(torch.from_numpy(x1), torch.from_numpy(x2),
               eps=tuple(torch.from_numpy(e) for e in eps))
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_allclose(g.item(), float(w), rtol=TERM_RTOL, err_msg=name)

    ref = vae_state_dict_from_jax(_np_tree(new.opt_state), _np_tree(new.batch_stats))
    params = dict(pm.named_parameters())
    for name, p in params.items():
        g, w = p.grad.numpy(), ref[name].numpy()
        if _is_pre_bn_bias(name):
            w_max = np.abs(ref[name[:-len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= PRE_BN_BIAS_SHARE * w_max, name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)
    for name, buf in pm.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(), atol=STATS_ATOL,
                                       err_msg=name)


def test_bf16_rounds_only_the_inputs():
    """compute_dtype="bfloat16" is the float32 step on bf16-rounded inputs,
    with the loss against the unrounded ones, and differs from float32."""
    _, v = _jax_vae(True)
    x1, x2, eps = _batch(5)
    e = tuple(torch.from_numpy(a) for a in eps)
    out = {}
    for dtype in ("bfloat16", "float32"):
        pm = _port_vae(v, True)
        out[dtype] = make_train_step(pm, make_optimizer(pm, 1e-4), compute_dtype=dtype)(
            torch.from_numpy(x1), torch.from_numpy(x2), eps=e)
    pm = _port_vae(v, True)
    r1, r2 = (torch.from_numpy(x).to(torch.bfloat16).float() for x in (x1, x2))
    outs = pm(r1, r2, eps=e)
    manual = losses.gvae_pair_loss(torch.from_numpy(x1), torch.from_numpy(x2), *outs)
    assert out["bfloat16"].total.item() == manual.total.item()
    assert out["bfloat16"].total.item() != out["float32"].total.item()


def test_adam_matches_optax():
    """Adam alone: identical gradients fed to torch's Adam and to dvc_tpu's
    optax.adam(lr, 0.9, 0.999, 1e-8) for three steps.  Held apart from the
    step because Adam's first update is +-lr wherever |g| >> eps, so a
    near-zero gradient whose sign differs between the packages moves a
    parameter by 2 lr."""
    rng = np.random.RandomState(6)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * s for s in (1.0, 1e-3, 30.0)]
    tx = optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(torch.nn.ParameterList([tp]), 1e-2)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        # the two update formulas round in another order: a few float32 ulps
        # of the parameter, 1.6e-7 measured against steps of ~1e-2
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)


# -- dataset -----------------------------------------------------------------

def _mel_tree(root, speakers=("p225", "p226"), utts=6, t_range=(10, 60), seed=0):
    rng = np.random.RandomState(seed)
    for spk in speakers:
        d = os.path.join(root, spk)
        os.makedirs(d, exist_ok=True)
        for u in range(utts):
            np.save(os.path.join(d, f"{spk}_{u:03d}_mel.npy"),
                    rng.rand(80, rng.randint(*t_range)).astype(np.float32))


def test_dataset_same_pairs_crops_batches(tmp_path):
    """One seed: the same pairs, crops and batch order as dvc_tpu's, over two
    epochs of re-pairing, and the same drop-remainder batch count."""
    _mel_tree(str(tmp_path), utts=7, t_range=(10, 40))
    jds = JaxPairedMelDataset(str(tmp_path), samples_length=16, seed=3)
    pds = PairedMelDataset(str(tmp_path), samples_length=16, seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(pds.utterance_fp, jds.utterance_fp)
        jb, pb = list(jds.batches(2)), list(prefetch(pds.batches(2)))
        assert len(pb) == len(jb) == len(jds) // 2
        for a, b in zip(jb, pb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
        jds.shuffle_data()
        pds.shuffle_data()
    tail = list(pds.batches(4, drop_remainder=False))
    assert [len(b[0]) for b in tail] == [4, 2]


def test_prefetch_reraises():
    def boom():
        yield 1
        raise RuntimeError("worker failed")
    with pytest.raises(RuntimeError, match="worker failed"):
        list(prefetch(boom()))


# -- checkpoints, the Trainer and the CLI -------------------------------------

def tiny_config(**train_kw) -> Config:
    train_kw = {"batch_size": 2, "compute_dtype": "float32", **train_kw}
    return Config(vae=VAEConfig(**SMALL), train=TrainConfig(**train_kw))


def test_checkpoint_save_and_resume(tmp_path):
    """save writes dvc_tpu's .msgpack, then the optimizer file and the model
    .pth beside it; resume
    restores the weights, the BN statistics, the step and Adam's state, so
    that 2 epochs + resume + 1 epoch end where 3 straight epochs do; the
    .pth loads into the serving DisentangledVAE as it is."""
    _mel_tree(str(tmp_path / "mels"))
    ck = str(tmp_path / "ck")

    def dataset():
        return PairedMelDataset(str(tmp_path / "mels"), samples_length=16, seed=0)

    quiet = dict(report_interval=1, logging_func=lambda *a: None)
    straight = Trainer(tiny_config(), device="cpu")
    straight.run_training(dataset(), 3, **quiet)
    ds = dataset()
    first = Trainer(tiny_config(), checkpoints_path=ck, device="cpu")
    first.run_training(ds, 2, **quiet)
    assert sorted(os.listdir(ck)) == [f"DisentangledVAE_VCTK_{e}{s}" for e in (1, 2)
                                      for s in (".msgpack", ".opt.pth", ".pth")]

    resumed = Trainer(tiny_config(), checkpoints_path=ck, device="cpu")
    assert resumed.load_last() == 3 and resumed.step == first.step > 0
    for (n, a), b in zip(first.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = first.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][f], sb[k][f])
    resumed.run_training(ds, 1, **quiet)  # epoch 3, from the resume point
    assert ckpt.latest_checkpoint_step(ck)[0] == 3
    for (n, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=n)

    serving = DisentangledVAE(VAEConfig(**SMALL))
    assert ckpt.load_last_checkpoint(ck, serving) == 3
    serving.eval()
    with torch.no_grad():
        out = serving.encode(torch.rand(2, 80, 16))
    assert all(torch.isfinite(o).all() for o in out)


def test_trainer_epochs_and_clamp(tmp_path):
    """The loss falls over epochs on a tiny corpus; a batch larger than the
    pair count clamps to it and says so; epochs count from the resume point;
    evaluate runs in eval mode and leaves the running statistics alone."""
    _mel_tree(str(tmp_path / "mels"))
    ds = PairedMelDataset(str(tmp_path / "mels"), samples_length=16, seed=0)
    said = []
    tr = Trainer(tiny_config(batch_size=64, learning_rate=1e-3),
                 checkpoints_path=str(tmp_path / "ck"), device="cpu")
    hist = tr.run_training(ds, 6, report_interval=3, logging_func=said.append)
    assert said[0] == f"batch_size 64 > {len(ds)} available pairs; training with batch {len(ds)}"
    totals = [h["total"] for h in hist]
    assert np.isfinite(totals).all() and totals[-1] < totals[0], totals
    assert tr.step == 6
    tr2 = Trainer(tiny_config(batch_size=64), checkpoints_path=str(tmp_path / "ck"),
                  device="cpu")
    tr2.run_training(ds, 2, report_interval=1, logging_func=lambda *a: None)
    assert ckpt.latest_checkpoint_step(str(tmp_path / "ck"))[0] == 8
    stats = {n: b.clone() for n, b in tr2.model.named_buffers()}
    # the crops draw from the dataset's seed, the z_style noise is seeded 0
    a, b = (tr2.evaluate(PairedMelDataset(str(tmp_path / "mels"), samples_length=16,
                                          seed=5), logging_func=lambda *a: None)
            for _ in range(2))
    assert a == b and np.isfinite(a["total"])
    assert tr2.model.training
    for n, buf in tr2.model.named_buffers():
        assert torch.equal(buf, stats[n]), n


def test_unported_settings_refused():
    cfg = tiny_config()
    assert unported_settings(cfg) == []
    bad = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float16"))
    with pytest.raises(NotImplementedError, match="float16.*not yet ported"):
        Trainer(bad, device="cpu")
    # orbax (test_torch_port_orbax.py), remat and the adversary
    # (test_torch_port_adversarial.py) are ported
    for ok in (cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_format="orbax")),
               cfg.replace(train=dataclasses.replace(cfg.train, remat=True)),
               cfg.replace(loss=dataclasses.replace(cfg.loss, adv_cof=1.0, adv_speakers=2))):
        assert unported_settings(ok) == []
        Trainer(ok, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(cfg, device="cuda")


def test_cli_train_then_convert(tmp_path, monkeypatch, capsys):
    """`train` on a 2-speaker synthetic corpus writes config.json, the
    checkpoints and TensorBoard scalars, and its loss falls; `convert` with
    the default Griffin-Lim vocoder then writes wavs from the checkpoint it
    wrote; `train --checkpoint-format orbax` resumes and writes the next
    epoch's .orbax beside the .pth pair."""
    from dvc_tpu_torch.utils.wavio import parse_wav
    _mel_tree(str(tmp_path / "mels"), utts=6, t_range=(20, 50))
    real_config = cli._config_from_args

    def small_config(args):  # the flags set frames/latent; widths are tiny
        cfg = real_config(args)
        widths = {k: v for k, v in SMALL.items() if k != "frames"}
        return cfg.replace(vae=dataclasses.replace(cfg.vae, **widths))

    monkeypatch.setattr(cli, "_config_from_args", small_config)
    run = tmp_path / "run"
    common = ["--dataset_fp", str(tmp_path / "mels"), "--log_dir", str(run),
              "--samples_length", "16", "--device", "cpu"]
    assert cli.main(["train", *common, "--epochs", "4", "--report-interval", "2",
                     "--batch-size", "2", "--compute-dtype", "float32", "--lr", "1e-3"]) == 0
    losses_ = [float(p.split("loss ")[1].split()[0])
               for p in capsys.readouterr().out.splitlines() if "Epoch" in p]
    assert len(losses_) == 4 and losses_[-1] < losses_[0], losses_
    assert (run / "config.json").exists()
    assert sorted(os.listdir(run / "checkpoints"))[-1] == "DisentangledVAE_VCTK_4.pth"
    assert os.listdir(run / "logs" / "DisentangledVAE_VCTK")
    assert cli.main(["convert", *common, "--src_spk", "p225", "--trg_spk", "p226",
                     "--num_utterances", "2", "--gl_iters", "4"]) == 0
    gen = run / "generation" / "p225_to_p226"
    wavs = sorted(gen.glob("*.wav"))
    assert len(wavs) == 2
    for w in wavs:
        wav, sr = parse_wav(w.read_bytes())
        assert sr == 16000 and len(wav) > 0 and np.isfinite(wav).all()
    assert cli.main(["train", *common, "--epochs", "5", "--report-interval", "1",
                     "--batch-size", "2", "--compute-dtype", "float32", "--lr", "1e-3",
                     "--checkpoint-format", "orbax"]) == 0
    ck = run / "checkpoints"
    assert {f"DisentangledVAE_VCTK_5{s}" for s in (".orbax", ".opt.pth", ".pth")} <= \
        set(os.listdir(ck))
    tree = ckpt.read_train_state(str(ck / "DisentangledVAE_VCTK_5.orbax"))
    assert int(tree["step"]) == int(tree["opt_state"]["0"]["count"]) > 0
