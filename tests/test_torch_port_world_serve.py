"""The WORLD route's model side of the port against dvc_tpu on the CPU: the
MCC-VAE's weights and one train step, convert_mcc and the conversion
functions, and WorldConversionService, directly, over HTTP and through
`serve --pipeline world`.

The MCC-VAE is 36 MCCs wide and narrow elsewhere (tests/test_train.py's
widths).  The same seeded numpy inputs and, through vae_state_dict_from_jax,
the same weights go to both packages; dvc_tpu's synthesis noise is put into
the port's synthesis_noise, and for the service both packages' Harvest is
pinned to the same f0.  Limits (measured in brackets):
  * the MCC-VAE and one train step: test_torch_port_train.py's limits
    (outputs 1e-3/1e-4, loss terms 1e-5 relative, gradients 1e-3 of their
    max, from the port in float32 and in float64);
  * convert_mcc: 1e-6 absolute (6.0e-8); the conversion through the
    native synthesizer 1e-5 of the peak (2.2e-7), through the device
    synthesis 1e-5 (5.0e-7);
  * the service's reply, plain and FS-masked: 1e-5 of the peak (6.3e-7).
"""

import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dvc_tpu import config as JC
from dvc_tpu import serve as jserve
from dvc_tpu.convert import world_conversion as jconv
from dvc_tpu.models.disentangled_vae import DisentangledVAE as JaxVAE
from dvc_tpu.ops import harvest as jharvest
from dvc_tpu.train.trainer import TrainState
from dvc_tpu.train.trainer import make_train_step as jax_make_train_step
from dvc_tpu_torch import serve as pserve
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import Config, VAEConfig
from dvc_tpu_torch.convert import world_conversion as pconv
from dvc_tpu_torch.data.world_preprocess import preprocess_world_dataset
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.ops import harvest as pharvest
from dvc_tpu_torch.ops import world as pworld
from dvc_tpu_torch.train.trainer import make_optimizer, make_train_step
from dvc_tpu_torch.utils.convert import vae_state_dict_from_jax
from dvc_tpu_torch.utils.wavio import parse_wav, read_wav, wav_bytes
from test_torch_port_train import (FULL_ATOL, FULL_RTOL, GRAD_RTOL, PRE_BN_BIAS_SHARE,
                                   TERM_RTOL, _grab_grads, _injector, _is_pre_bn_bias,
                                   _np_tree)
from test_torch_port_world_route import MCC, SR, _npz, voice, wav_dir  # noqa: F401 (fixture)
from test_torch_port_world_synthesis import jax_noise

B = 4
CONVERT_ATOL = 1e-6
NATIVE_PEAK_RTOL = 1e-5
DEVICE_PEAK_RTOL = 1e-5
SERVE_PEAK_RTOL = 1e-5


@pytest.fixture(scope="module")
def world_dir(wav_dir, tmp_path_factory):
    """The port's preprocess-world output (per-speaker npz and statistics)."""
    out = tmp_path_factory.mktemp("world") / "w"
    preprocess_world_dataset(str(wav_dir), str(out), device="cpu")
    return out


@pytest.fixture(scope="module")
def mcc_vae():
    jm = JaxVAE(JC.VAEConfig(**MCC))
    x = jnp.zeros((2, 36, MCC["frames"]), jnp.float32)
    key = jax.random.PRNGKey(0)
    v = jm.init({"params": key, "reparam": key}, x, x, train=True)
    return jm, v


def _port_mcc_vae(v):
    pm = DisentangledVAE(VAEConfig(**MCC))
    pm.load_state_dict(vae_state_dict_from_jax(_np_tree(v["params"]), _np_tree(v["batch_stats"])))
    return pm


def test_mcc_vae_weights_carry(mcc_vae):
    """vae_state_dict_from_jax carries an MCC-VAE unchanged: encode and
    decode in eval mode at test_torch_port_train.py's full-VAE limits."""
    jm, v = mcc_vae
    pm = _port_mcc_vae(v).eval()
    x = np.random.RandomState(1).randn(3, 36, MCC["frames"]).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(x))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FULL_RTOL, atol=FULL_ATOL)
        z = torch.cat([got[0], got[2]], -1)
        dec = pm.decode(z).numpy()
    assert dec.shape == (3, 36, MCC["frames"])
    np.testing.assert_allclose(dec, np.asarray(jm.apply(v, jnp.asarray(z.numpy()),
                                                        method="decode")),
                               rtol=FULL_RTOL, atol=FULL_ATOL)


@pytest.fixture(scope="module")
def mcc_step(mcc_vae):
    """dvc_tpu's train step on normalized-MCC pairs, its noise injected:
    (inputs, noise, loss terms, state after the step)."""
    jm, v = mcc_vae
    rng = np.random.RandomState(4)
    x1, x2 = (rng.randn(B, 36, MCC["frames"]).astype(np.float32) for _ in range(2))
    eps = [rng.randn(B, 28).astype(np.float32), rng.randn(B, 28).astype(np.float32),
           rng.randn(B, 4).astype(np.float32)]
    opt = _grab_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=opt.init(v["params"]))
    icpt, calls = _injector(eps)
    with fnn.intercept_methods(icpt):
        new, want = jax_make_train_step(jm, opt, compute_dtype="float32", jit=False)(
            state, jnp.asarray(x1), jnp.asarray(x2), jax.random.PRNGKey(0))
    assert len(calls) == 3
    return (x1, x2), eps, want, new


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_step_mcc(mcc_vae, mcc_step, dtype):
    """One step on normalized-MCC pairs from the same weights, batch and
    noise: the loss terms and every gradient against dvc_tpu's
    make_train_step(jit=False); the port's gradients in float32 and in
    float64."""
    _, v = mcc_vae
    (x1, x2), eps, want, new = mcc_step
    pm = _port_mcc_vae(v).to(dtype).train()
    step = make_train_step(pm, make_optimizer(pm, 1e-4), compute_dtype="float32")
    got = step(*(torch.from_numpy(x).to(dtype) for x in (x1, x2)),
               eps=tuple(torch.from_numpy(e).to(dtype) for e in eps))
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_allclose(g.item(), float(w), rtol=TERM_RTOL, err_msg=name)
    ref = vae_state_dict_from_jax(_np_tree(new.opt_state), _np_tree(new.batch_stats))
    for name, p in pm.named_parameters():
        g, w = p.grad.double().numpy(), ref[name].double().numpy()
        if _is_pre_bn_bias(name):
            w_max = np.abs(ref[name[:-len("bias")] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= PRE_BN_BIAS_SHARE * w_max, name
            continue
        assert np.abs(g - w).max() / np.abs(w).max() <= GRAD_RTOL, name


def _stats(world, name):
    with np.load(world / name) as z:
        return dict(z)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "fs_mask"])
def test_conversion_with_carried_weights(mcc_vae, world_dir, monkeypatch, masked):
    """convert_mcc, then the whole conversion of two utterances through the
    native synthesizer and through the batched device synthesis."""
    jm, v = mcc_vae
    pm = _port_mcc_vae(v).eval()
    port = world_dir
    mask = np.zeros(32, np.float32)
    mask[[0, 1, 2, 3, 7, 20]] = 1.0
    mask = mask if masked else None
    src, trg = [_npz(port, "p225", i) for i in (0, 1)], [_npz(port, "p226", i) for i in (2, 1)]
    want = jconv.convert_mcc(jm, v, src[0]["normalized_mc"].T, trg[0]["normalized_mc"].T,
                             MCC["frames"], fs_mask=mask)
    got = pconv.convert_mcc(pm, src[0]["normalized_mc"].T, trg[0]["normalized_mc"].T,
                            MCC["frames"], fs_mask=mask)
    assert got.shape == want.shape and got.shape[1] % MCC["frames"] == 0
    assert np.abs(got - want).max() <= CONVERT_ATOL

    trg_stats = _stats(port, "mcep_p226.npz")
    lf0 = [{k: float(v_) for k, v_ in _stats(port, f"log_f0_{s}.npz").items()}
           for s in ("p225", "p226")]
    args = (trg_stats, lf0[0], lf0[1])
    kw = dict(frames=MCC["frames"], fs_mask=mask)
    w = jconv.world_convert_utterance(jm, v, src[0], trg[0], *args, **kw)
    g = pconv.world_convert_utterance(pm, src[0], trg[0], *args, **kw)
    assert g.shape == w.shape == (len(src[0]["f0"]) * 80,)
    assert np.abs(g - w).max() <= NATIVE_PEAK_RTOL * np.abs(w).max()
    monkeypatch.setattr(pworld, "synthesis_noise", jax_noise)
    ws = jconv.world_convert_corpus(jm, v, src, trg, *args, **kw)
    gs = pconv.world_convert_corpus(pm, src, trg, *args, **kw)
    for g, w in zip(gs, ws):
        assert g.shape == w.shape and np.abs(g - w).max() <= DEVICE_PEAK_RTOL * np.abs(w).max()


def _pin_f0(monkeypatch, wav):
    """Both packages' Harvest returns the port's f0 of ``wav`` (alone in its
    length bucket, as world_decompose_batch pads it)."""
    bucket = int(np.ceil((len(wav) + 1) / 8000)) * 8000
    padded = np.zeros((1, bucket), np.float32)
    padded[0, :len(wav)] = wav
    f0 = pharvest.harvest_batch(torch.from_numpy(padded), [len(wav)])

    def port(batch, lengths, *a, **k):
        assert tuple(batch.shape) == padded.shape and list(lengths) == [len(wav)]
        return f0.clone()

    def dvc(batch, lengths=None, *a, **k):
        assert tuple(batch.shape) == padded.shape
        return jnp.asarray(f0.numpy())

    monkeypatch.setattr(pharvest, "harvest_batch", port)
    monkeypatch.setattr(jharvest, "harvest_batch", dvc)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "fs_mask"])
def test_service_reply_against_dvc_tpu(mcc_vae, world_dir, wav_dir, monkeypatch, masked):
    """One request through both packages' WorldConversionService, f0 and
    noise pinned: the same reply; a second request for the same speaker
    reads the cached assets."""
    jm, v = mcc_vae
    mask = None
    if masked:
        mask = np.zeros(32, np.float32)
        mask[[0, 1, 2, 3, 9]] = 1.0
    wav = read_wav(str(sorted((wav_dir / "p225").glob("*.wav"))[1]))[0]
    _pin_f0(monkeypatch, wav)
    monkeypatch.setattr(pworld, "synthesis_noise", jax_noise)
    js = jserve.WorldConversionService(JC.Config(vae=JC.VAEConfig(**MCC)), jm, v,
                                       str(world_dir), fs_mask=mask)
    ps = pserve.WorldConversionService(Config(vae=VAEConfig(**MCC)), _port_mcc_vae(v),
                                       str(world_dir), fs_mask=mask, device="cpu")
    want, got = js.submit(wav, "p226"), ps.submit(wav, "p226")
    assert got.dtype == np.float32 and got.shape == want.shape == ((len(wav) // 80 + 1) * 80,)
    assert np.abs(got - want).max() <= SERVE_PEAK_RTOL * np.abs(want).max()
    assert np.abs(ps.submit(wav, "p226") - got).max() == 0.0
    assert list(ps._asset_cache) == ["p226"] and ps.stats["requests"] == 2
    with pytest.raises(KeyError, match="unknown target speaker"):
        ps.submit(wav, "p999")


def test_http_and_cli(mcc_vae, world_dir, wav_dir, tmp_path, monkeypatch):
    """Three concurrent POST /convert (one at 22.05 kHz) drain into one
    batch and come back as 16 kHz wavs of the resampled length; `serve
    --pipeline world` builds this service from a run's checkpoint."""
    _, v = mcc_vae
    ps = pserve.WorldConversionService(Config(vae=VAEConfig(**MCC)), _port_mcc_vae(v),
                                       str(world_dir), max_wait_ms=1000.0, device="cpu")
    srv = pserve.make_http_server(ps, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/convert?trg_spk=p225"
    bodies = [wav_bytes(*read_wav(str(p))) for p in
              (sorted((wav_dir / "p226").glob("*.wav"))[0],  # 22.05 kHz
               *sorted((wav_dir / "p225").glob("*.wav"))[:2])]
    replies = [None] * 3

    def post(i):
        with urllib.request.urlopen(urllib.request.Request(url, data=bodies[i]),
                                    timeout=120) as r:
            replies[i] = parse_wav(r.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
        srv.server_close()
    for body, (w, sr) in zip(bodies, replies):
        x, sr_in = parse_wav(body)
        n = -(-len(x) * SR // sr_in)  # resample_poly's length
        assert sr == SR and w.shape == ((n // 80 + 1) * 80,) and np.isfinite(w).all()
    assert ps.stats["batches"] == 1 and ps.stats["requests"] == 3

    ck = tmp_path / "run" / "checkpoints"
    ck.mkdir(parents=True)
    torch.save(_port_mcc_vae(v).state_dict(), ck / "DisentangledVAE_VCTK_1.pth")
    real_config, served = cli._config_from_args, {}

    def narrow(args):
        cfg = real_config(args)
        return cfg.replace(vae=VAEConfig(**MCC))

    def fake_serve(server, what):
        served["what"] = what
        server.server_close()

    monkeypatch.setattr(cli, "_config_from_args", narrow)
    monkeypatch.setattr(cli, "_serve_forever", fake_serve)
    assert cli.main(["serve", "--pipeline", "world", "--dataset_fp", str(world_dir),
                     "--log_dir", str(tmp_path / "run"), "--port", "0",
                     "--device", "cpu"]) == 0
    assert served["what"] == "2 target speakers, WORLD pipeline, device cpu"
