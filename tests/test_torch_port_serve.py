"""The serving slice as a whole: the port's ConversionService and HTTP
server against dvc_tpu's, with weights carried across by the bridge, and
the port's CLI over a reference-format checkpoint."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import dataclasses
import io
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu import serve as jserve
from dvc_tpu.config import Config as JaxConfig
from dvc_tpu.config import VAEConfig as JaxVAEConfig
from dvc_tpu.config import VocoderConfig as JaxVocoderConfig
from dvc_tpu.convert.vocode import make_vocoder as jax_make_vocoder
from dvc_tpu.models.disentangled_vae import DisentangledVAE as JaxVAE
from dvc_tpu.models.wavenet import WaveNet as JaxWaveNet
from dvc_tpu_torch import serve
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import Config, VAEConfig, VocoderConfig
from dvc_tpu_torch.convert.conversion import binarize_fs_mask
from dvc_tpu_torch.convert.vocode import make_vocoder
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.utils.convert import vae_state_dict_from_jax, wavenet_state_dict_from_jax
from dvc_tpu_torch.utils.wavio import parse_wav, wav_bytes

SMALL = dict(frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
             dec_lstm2_hidden=32, postnet_channels=32)
VOC = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16,
           skip_out_channels=8, cin_channels=80, upsample_scales=(2, 2), out_channels=6)
FULL_RTOL, FULL_ATOL = 1e-3, 1e-4   # the full-VAE gate (tests/test_torch_parity.py:234-244)
WAV_ATOL = 1e-3                      # float waveform through VAE + AR sampler


@pytest.fixture(scope="module")
def weights():
    jm = JaxVAE(JaxVAEConfig(**SMALL))
    x = jnp.zeros((2, 80, SMALL["frames"]), jnp.float32)
    key = jax.random.PRNGKey(0)
    v = jm.init({"params": key, "reparam": key}, x, x, train=True)
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        {"params": v["params"], "batch_stats": v["batch_stats"]})
    sd = vae_state_dict_from_jax(variables["params"], variables["batch_stats"])
    return jm, variables, sd


def _port_model(sd):
    m = DisentangledVAE(VAEConfig(**SMALL))
    m.load_state_dict(sd)
    return m


@pytest.fixture(scope="module")
def mel_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mels")
    rng = np.random.RandomState(0)
    for spk in ("p1", "p2"):
        (d / spk).mkdir()
        for i in range(2):
            np.save(d / spk / f"{spk}_{i:03d}_mel.npy", rng.rand(80, 40).astype(np.float32))
    return d


def _doctored_wavenet():
    """dvc_tpu WaveNet params with the deterministic head of
    tests/test_pallas_wavenet.py:26-44 (any RNG gives the same samples)."""
    cfg = JaxVocoderConfig(**VOC)
    v = JaxWaveNet(cfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 12, 1)),
                             jnp.ones((1, 3, 80)))
    params = jax.tree_util.tree_map(np.array, jax.device_get(v["params"]))
    k, b = params["final2"]["kernel"], params["final2"]["bias"]
    k[..., :2] = 0.0
    k[..., 4:] = 0.0
    b[:2] = -10.0
    b[0] = 10.0
    b[4:] = -40.0
    k[..., 2:4] *= 20.0
    return cfg, {"params": params}


@pytest.mark.parametrize("masked", [False, True])
def test_mel_out_service_matches(weights, mel_dir, masked):
    jm, variables, sd = weights
    mask = binarize_fs_mask(np.random.RandomState(1).rand(32), 4, top_k=6) if masked else None
    jsvc = jserve.ConversionService(JaxConfig(vae=JaxVAEConfig(**SMALL)), jm, variables,
                                    str(mel_dir), vocoder=None, fs_mask=mask)
    psvc = serve.ConversionService(Config(vae=VAEConfig(**SMALL)), _port_model(sd),
                                   str(mel_dir), vocoder=None, fs_mask=mask, device="cpu")
    for i, (t, spk) in enumerate(((33, "p2"), (16, "p1"), (5, "p2"))):
        mel = np.random.RandomState(10 + i).rand(80, t).astype(np.float32)
        want = jsvc.submit(mel, spk)
        got = psvc.submit(mel, spk)
        assert got.shape == want.shape == (80, (t // 16 + 1) * 16)
        np.testing.assert_allclose(got, want, rtol=FULL_RTOL, atol=FULL_ATOL)
    np.testing.assert_allclose(psvc.target_style("p1").numpy(),
                               np.asarray(jsvc.target_style("p1")),
                               rtol=FULL_RTOL, atol=FULL_ATOL)


def test_wavenet_service_matches_scan(weights, mel_dir):
    """With the WaveNet vocoder (doctored head) the port's float waveform
    matches dvc_tpu's make_vocoder(backend="scan") path."""
    jm, variables, sd = weights
    jcfg, wv = _doctored_wavenet()
    jvoc = jax_make_vocoder(None, jcfg, backend="scan", pad_frames_to=8, variables=wv)
    pvoc = make_vocoder(None, VocoderConfig(**VOC), pad_frames_to=8,
                        variables=wavenet_state_dict_from_jax(wv["params"]), device="cpu")
    jsvc = jserve.ConversionService(JaxConfig(vae=JaxVAEConfig(**SMALL)), jm, variables,
                                    str(mel_dir), vocoder=jvoc)
    psvc = serve.ConversionService(Config(vae=VAEConfig(**SMALL)), _port_model(sd),
                                   str(mel_dir), vocoder=pvoc, device="cpu")
    mel = np.random.RandomState(5).rand(80, 20).astype(np.float32)
    want = jsvc.submit(mel, "p1")
    got = psvc.submit(mel, "p1")
    assert got.shape == want.shape == (2 * 16 * 4,)
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=WAV_ATOL)


@pytest.fixture(scope="module")
def server(weights, mel_dir):
    _, _, sd = weights
    svc = serve.ConversionService(Config(vae=VAEConfig(**SMALL)), _port_model(sd),
                                  str(mel_dir), vocoder=None, max_wait_ms=300.0,
                                  device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = serve.make_http_server(svc, "127.0.0.1", port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{port}"
    srv.shutdown()
    srv.server_close()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _sine(seconds=0.4, sr=16000, seed=0):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.RandomState(seed)
    return (0.4 * np.sin(2 * np.pi * 200 * t) + 0.02 * rng.randn(len(t))).astype(np.float32)


def test_http_round_trip(server, weights, mel_dir):
    """POST a wav; the reply is the npy mel of dvc_tpu's server on the same
    wav (same framing, bucketing and conversion), for a 16 kHz body and for
    a 22.05 kHz body, which both servers resample to 16 kHz."""
    svc, url = server
    import json
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "speakers": ["p1", "p2"]}
    body = wav_bytes(_sine(), 16000)
    body_22k = wav_bytes(_sine(sr=22050), 22050)
    got = []
    for b in (body, body_22k):
        status, data = _post(url + "/convert?trg_spk=p2", b)
        assert status == 200
        got.append(np.load(io.BytesIO(data)))

    jm, variables, _ = weights
    jsvc = jserve.ConversionService(JaxConfig(vae=JaxVAEConfig(**SMALL)), jm, variables,
                                    str(mel_dir), vocoder=None)
    jsrv = jserve.make_http_server(jsvc, "127.0.0.1", 0)
    jt = threading.Thread(target=jsrv.serve_forever, daemon=True)
    jt.start()
    try:
        want = [np.load(io.BytesIO(_post(
            f"http://127.0.0.1:{jsrv.server_address[1]}/convert?trg_spk=p2", b)[1]))
            for b in (body, body_22k)]
    finally:
        jsrv.shutdown()
        jsrv.server_close()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=FULL_RTOL, atol=FULL_ATOL)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/convert?trg_spk=nobody", body)
    assert e.value.code == 404


def test_micro_batching_aggregates(server):
    svc, _ = server
    before = dict(svc.stats)
    results = [None] * 4

    def worker(i):
        results[i] = svc.submit(np.random.RandomState(i).rand(80, 20).astype(np.float32), "p1")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and np.isfinite(r).all() for r in results)
    dreq = svc.stats["requests"] - before["requests"]
    dbat = svc.stats["batches"] - before["batches"]
    assert dreq == 4 and dbat < dreq  # the 300 ms window merged requests


def test_bad_speaker_fails_alone(server):
    svc, _ = server
    with pytest.raises(KeyError, match="unknown target speaker"):
        svc.submit(np.random.rand(80, 20).astype(np.float32), "nope")
    assert np.isfinite(svc.submit(np.random.rand(80, 20).astype(np.float32), "p1")).all()


def test_cli_convert_and_vocode(weights, mel_dir, tmp_path, monkeypatch):
    """Latest-wins checkpoint discovery + `convert` with the WaveNet vocoder
    and `vocode`, on the CPU; the iSTFT vocoder without --vocoder_ckpt exits
    with dvc_tpu's message (Griffin-Lim, the default, is held in
    tests/test_torch_port_griffinlim.py)."""
    _, _, sd = weights
    ck = tmp_path / "run" / "checkpoints"
    ck.mkdir(parents=True)
    torch.save({k: torch.zeros_like(v) for k, v in sd.items()},
               ck / "DisentangledVAE_VCTK_9.pth")
    torch.save(sd, ck / "DisentangledVAE_VCTK_10.pth")
    _, wv = _doctored_wavenet()
    voc_path = tmp_path / "wavenet.pth"
    torch.save({"state_dict": wavenet_state_dict_from_jax(wv["params"])}, voc_path)

    import dvc_tpu_torch.convert.vocode as vocode_mod

    def tiny_vocoder(path, **kw):  # the CLI builds the reference geometry
        return make_vocoder(path, VocoderConfig(**VOC), **kw)

    monkeypatch.setattr(vocode_mod, "make_vocoder", tiny_vocoder)
    real_config = cli._config_from_args

    def small_config(args):  # the flags set frames/latent; widths are fixed
        cfg = real_config(args)
        widths = {k: v for k, v in SMALL.items() if k != "frames"}
        return dataclasses.replace(cfg, vae=dataclasses.replace(cfg.vae, **widths))

    monkeypatch.setattr(cli, "_config_from_args", small_config)
    common = ["--dataset_fp", str(mel_dir), "--log_dir", str(tmp_path / "run"),
              "--samples_length", "16", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--vocoder istft needs --vocoder_ckpt"):
        cli.main(["convert", *common, "--src_spk", "p1", "--trg_spk", "p2",
                  "--vocoder", "istft"])
    assert cli.main(["convert", *common, "--src_spk", "p1", "--trg_spk", "p2",
                     "--num_utterances", "1", "--vocoder_ckpt", str(voc_path)]) == 0
    mel_path = tmp_path / "m.npy"
    np.save(mel_path, np.random.RandomState(0).rand(80, 8).astype(np.float32))
    assert cli.main(["vocode", str(mel_path), "--vocoder_ckpt", str(voc_path),
                     "--device", "cpu"]) == 0
    wav, sr = parse_wav((tmp_path / "run" / "generation" / "p1_to_p2"
                         / "convert_p1_to_p2_000.wav").read_bytes())
    assert sr == 16000 and wav.shape == ((40 // 16 + 1) * 16 * 4,)
    assert parse_wav((tmp_path / "m_vocoded.wav").read_bytes())[0].shape == (32,)
