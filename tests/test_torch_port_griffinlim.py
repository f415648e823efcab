"""The serving defaults of the port against dvc_tpu on the CPU: the mel
inversion chain and Griffin-Lim (single, batched, short mels), rational
resampling, and the profile-transfer route (speaker_mel_profile,
VoiceConverter, ProfileTransferService over HTTP, the CLI).  The same
seeded numpy inputs go to both packages."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import io
import socket
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu import serve as jserve
from dvc_tpu.config import AudioConfig as JaxAudioConfig
from dvc_tpu.config import Config as JaxConfig
from dvc_tpu.convert import conversion as jconv
from dvc_tpu.convert import griffinlim as jgl
from dvc_tpu.ops import audio as jaudio
from dvc_tpu.ops import mel as jmel
from dvc_tpu_torch import serve
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.config import AudioConfig, Config
from dvc_tpu_torch.convert import conversion
from dvc_tpu_torch.convert import griffinlim as gl
from dvc_tpu_torch.ops import audio, mel
from dvc_tpu_torch.utils.wavio import parse_wav, wav_bytes

ACFG, JACFG = AudioConfig(), JaxAudioConfig()
# |STFT| from the pinv projection: float32 dots of 80 terms in another
# order, ~2e-6 measured on magnitudes up to ~17
MAG_ATOL = 1e-4
# Griffin-Lim waveforms, max |diff| over the reference's max |x|: the phase
# update divides by |spec|, which enlarges float32 rounding in quiet bins at
# every iteration (on a pure sine, 32 iterations turn a 1e-7 change of the
# magnitude into a different waveform); up to 1.8e-5 measured on these mels,
# 6e-4 on unscaled random mels at 8 iterations
GL_RTOL = 3e-3
# resampling: one float32 FIR sum of up to 14,935 taps in another order,
# ~3e-7 measured on signals of max ~0.9
RESAMPLE_ATOL = 2e-6
# mels from wavs (STFT, filterbank, dB): as tests/test_torch_port_ops.py
MEL_ATOL = 1e-4


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def test_db_and_denormalize():
    x = np.linspace(-120, 40, 33).astype(np.float32)
    np.testing.assert_allclose(mel.db_to_amp(torch.from_numpy(x)).numpy(),
                               np.asarray(jmel.db_to_amp(jnp.asarray(x))), rtol=1e-6)
    s = np.linspace(-0.5, 1.5, 33).astype(np.float32)
    np.testing.assert_allclose(mel.denormalize_mel(torch.from_numpy(s)).numpy(),
                               np.asarray(jmel.denormalize_mel(jnp.asarray(s))), rtol=1e-6)


@pytest.mark.parametrize("n_iter", [4, 32])
@pytest.mark.parametrize("frames", [3, 20, 41])
def test_griffin_lim(frames, n_iter):
    """The magnitude from a mel, then Griffin-Lim with the default length;
    3 frames is shorter than fft/hop + 1, where no length frames to the mel
    and both pad the magnitude and crop back to frames * hop."""
    m = (np.random.RandomState(frames).rand(80, frames) * 0.8).astype(np.float32)
    want_mag = np.array(jgl.mel_to_stft_magnitude(jnp.asarray(m), JACFG))
    got_mag = gl.mel_to_stft_magnitude(torch.from_numpy(m), ACFG).numpy()
    assert got_mag.shape == want_mag.shape == (frames, ACFG.fft_size // 2 + 1)
    np.testing.assert_allclose(got_mag, want_mag, atol=MAG_ATOL)
    want = jgl.griffin_lim(jnp.asarray(want_mag), JACFG, n_iter)
    got = gl.griffin_lim(torch.from_numpy(want_mag), ACFG, n_iter)
    assert got.shape == want.shape
    if frames < ACFG.fft_size // ACFG.hop_size + 1:
        assert gl._max_length_for_frames(frames, ACFG) is None
        assert got.shape == (frames * ACFG.hop_size,)
    assert got.shape[-1] == gl.default_inversion_length(frames, ACFG) \
        == jgl.default_inversion_length(frames, JACFG)
    assert _rel(got, want) <= GL_RTOL


def test_inversion_plans_match():
    for m in range(1, 70):
        assert gl._max_length_for_frames(m, ACFG) == jgl._max_length_for_frames(m, JACFG)
        assert gl.default_inversion_length(m, ACFG) == jgl.default_inversion_length(m, JACFG)
    for m in (1, 2, 3, 4):
        assert gl._padded_inversion_plan(m, ACFG) == jgl._padded_inversion_plan(m, JACFG)


def test_istft_inverts_stft():
    x = np.random.RandomState(2).randn(2, 4000).astype(np.float32)
    spec = gl._stft_complex(torch.from_numpy(x), ACFG)
    np.testing.assert_allclose(gl.istft(spec, 4000, ACFG).numpy(), x, atol=1e-4)
    want = np.asarray(jgl.istft(jnp.asarray(spec.numpy()), 4000, JACFG))
    np.testing.assert_allclose(gl.istft(spec, 4000, ACFG).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n_iter", [4, 32])
def test_mel_to_waveform_and_batch_vocoder(n_iter):
    """mel_to_waveform, and the .batch vocoder padded as dvc_tpu pads it: each
    output has its single call's length, including a mel of 3 frames."""
    rng = np.random.RandomState(7)
    mels = [(rng.rand(80, t) * 0.8).astype(np.float32) for t in (3, 17, 30)]
    for m in mels:
        want = jgl.mel_to_waveform(m, JACFG, n_iter)
        got = gl.mel_to_waveform(m, ACFG, n_iter, device="cpu")
        assert got.dtype == np.float32 and got.shape == want.shape
        assert _rel(got, want) <= GL_RTOL
    want = jgl.make_griffinlim_vocoder(JACFG, n_iter).batch(mels)
    voc = gl.make_griffinlim_vocoder(ACFG, n_iter, device="cpu")
    got = voc.batch(mels)
    for g, w, m in zip(got, want, mels):
        assert g.shape == w.shape == (gl.default_inversion_length(m.shape[1], ACFG),)
        assert _rel(g, w) <= GL_RTOL
    assert voc.batch([]) == []
    with pytest.raises(RuntimeError, match="no CUDA card"):
        gl.make_griffinlim_vocoder(ACFG, n_iter)


@pytest.mark.parametrize("sr", [22050, 44100, 48000, 8000])
def test_resample_poly(sr):
    """To 16 kHz, at lengths where the crop to ceil(t * up / down) needs the
    right padding past the filter half, and batched."""
    rng = np.random.RandomState(sr % 97)
    for n in (sr // 5, sr // 5 + 7, 3):
        w = (rng.randn(2, n) * 0.3).astype(np.float32)
        want = np.asarray(jaudio.resample_poly(jnp.asarray(w), sr, 16000))
        got = audio.resample_poly(torch.from_numpy(w), sr, 16000).numpy()
        assert got.shape == want.shape == (2, -(-n * 16000 // sr))
        np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL)
    np.testing.assert_array_equal(audio._sinc_kernel(160, 441), jaudio._sinc_kernel(160, 441))
    x = torch.randn(5)
    assert audio.resample_poly(x, 16000, 16000) is x


@pytest.fixture(scope="module")
def mel_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mels")
    rng = np.random.RandomState(0)
    for spk, n in (("p1", 3), ("p2", 4)):
        (d / spk).mkdir()
        for i in range(n):
            np.save(d / spk / f"{spk}_{i:03d}_mel.npy",
                    (rng.rand(80, 20 + 9 * i) * (0.5 + 0.2 * i)).astype(np.float32))
    return d


def test_profile_transfer_route(mel_dir, tmp_path):
    """speaker_mel_profile, and VoiceConverter(profile_transfer=True) with a
    Griffin-Lim vocoder, against dvc_tpu's on the same directory."""
    fps = sorted((mel_dir / "p2").glob("*.npy"))
    for k in (32, 2):
        np.testing.assert_allclose(conversion.speaker_mel_profile(fps, k),
                                   jconv.speaker_mel_profile(fps, k), rtol=1e-6)
    with pytest.raises(FileNotFoundError):
        conversion.speaker_mel_profile([])
    want = jconv.VoiceConverter(JaxConfig(), None, None, seed=1, profile_transfer=True
                                ).convert_speaker_pair(
        str(mel_dir), "p1", "p2", str(tmp_path / "gen_jax"), 2,
        vocoder=jgl.make_griffinlim_vocoder(JACFG, 4), save_png=False)
    got = conversion.VoiceConverter(Config(), None, seed=1, profile_transfer=True
                                    ).convert_speaker_pair(
        str(mel_dir), "p1", "p2", str(tmp_path / "gen_port"), 2,
        vocoder=gl.make_griffinlim_vocoder(ACFG, 4, device="cpu"), save_png=False)
    assert [g[0] for g in got] == [w[0] for w in want] == ["000", "001"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_allclose(g[2], w[2], rtol=1e-6, atol=1e-7)
        assert _rel(g[3], w[3]) <= GL_RTOL
    wav, sr = parse_wav((tmp_path / "gen_port" / "p1_to_p2" / "convert_p1_to_p2_000.wav")
                        .read_bytes())
    assert sr == 16000 and wav.shape == got[0][3].shape
    with pytest.raises(ValueError, match="model-free"):
        conversion.VoiceConverter(Config(), None, profile_transfer=True,
                                  fs_mask=np.ones(32, np.float32)).convert_speaker_pair(
            str(mel_dir), "p1", "p2", str(tmp_path / "gen_bad"), 1)


def _serve(svc):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = serve.make_http_server(svc, "127.0.0.1", port) if isinstance(
        svc, serve._MicroBatchService) else jserve.make_http_server(svc, "127.0.0.1", port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, f"http://127.0.0.1:{port}"


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_profile_transfer_service(mel_dir):
    """ProfileTransferService over HTTP in mel-out mode against dvc_tpu's, at
    16 kHz and at 22.05 kHz (resampled by both), and with the Griffin-Lim
    vocoder through submit; an unknown speaker fails alone."""
    psvc = serve.ProfileTransferService(Config(), str(mel_dir), max_wait_ms=50.0,
                                        device="cpu")
    jsvc = jserve.ProfileTransferService(JaxConfig(), str(mel_dir), max_wait_ms=50.0)
    np.testing.assert_allclose(psvc.target_profile("p2"), jsvc.target_profile("p2"),
                               rtol=1e-6)
    t = np.arange(int(0.3 * 22050)) / 22050
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    bodies = [wav_bytes(wav[:4800], 16000), wav_bytes(wav, 22050)]
    replies = {}
    for name, svc in (("port", psvc), ("jax", jsvc)):
        srv, url = _serve(svc)
        try:
            replies[name] = [np.load(io.BytesIO(_post(url + "/convert?trg_spk=p2", b)[1]))
                             for b in bodies]
        finally:
            srv.shutdown()
            srv.server_close()
    for g, w in zip(replies["port"], replies["jax"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=MEL_ATOL)
    with pytest.raises(KeyError, match="unknown target speaker"):
        psvc.submit(replies["port"][0], "nobody")

    src = replies["port"][1]
    pv = serve.ProfileTransferService(Config(), str(mel_dir), device="cpu",
                                      vocoder=gl.make_griffinlim_vocoder(ACFG, 4, "cpu"))
    jv = jserve.ProfileTransferService(JaxConfig(), str(mel_dir),
                                       vocoder=jgl.make_griffinlim_vocoder(JACFG, 4))
    got, want = pv.submit(src, "p1"), jv.submit(src, "p1")
    assert got.shape == want.shape and _rel(got, want) <= GL_RTOL
    assert pv.stats["requests"] == 1 and pv.stats["chunks"] == src.shape[1] // 64 + 1


def test_cli_profile_transfer_and_vocode(mel_dir, tmp_path, monkeypatch):
    """`convert --profile_transfer` needs no checkpoint and writes wavs with
    the default Griffin-Lim vocoder; `vocode` without a checkpoint is
    Griffin-Lim; serve's argument checks are dvc_tpu's."""
    common = ["--dataset_fp", str(mel_dir), "--log_dir", str(tmp_path / "run"),
              "--device", "cpu", "--gl_iters", "4"]
    assert cli.main(["convert", *common, "--profile_transfer", "--src_spk", "p1",
                     "--trg_spk", "p2"]) == 0
    assert len(list((tmp_path / "run" / "generation" / "p1_to_p2").glob("*.wav"))) == 2
    m = np.load(sorted((mel_dir / "p1").glob("*.npy"))[0])
    np.save(tmp_path / "m.npy", m)
    assert cli.main(["vocode", str(tmp_path / "m.npy"), "--gl_iters", "4",
                     "--device", "cpu"]) == 0
    wav, _ = parse_wav((tmp_path / "m_vocoded.wav").read_bytes())
    assert wav.shape == (gl.default_inversion_length(m.shape[1], ACFG),)
    with pytest.raises(SystemExit, match="fs_mask does not apply"):
        cli.main(["serve", *common, "--profile_transfer", "--fs_mask", "x.npz"])
    with pytest.raises(SystemExit, match="mel pipeline only"):
        cli.main(["serve", *common, "--profile_transfer", "--pipeline", "world"])
    with pytest.raises(SystemExit, match="fs_mask does not apply"):
        cli.main(["convert", *common, "--profile_transfer", "--fs_mask", "x.npz"])
    served = {}

    def fake_serve(server, what):
        served["what"] = what
        server.server_close()

    monkeypatch.setattr(cli, "_serve_forever", fake_serve)
    assert cli.main(["serve", *common, "--profile_transfer", "--port", "0"]) == 0
    assert "profile-transfer" in served["what"] and "2 target speakers" in served["what"]
