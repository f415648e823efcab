"""The preprocess slice of the port against dvc_tpu on the CPU: the audio
ops (volume, peak rescaling, mu-law, the energy and gmm VAD masks, the
silence trim), read_audio (wav, FLAC through the port's own decoder, m4a),
the mel extractor's two backends, and preprocess_dataset on a small
synthetic VCTK-layout corpus with and without trimming.

The same seeded numpy inputs go to both packages.  Tolerances: float32
elementwise ops 1 ulp-scale (2.4e-7 absolute at |x| <= 1, measured 1.2e-7
and 2.4e-7 for mu-law); VAD masks and trims equal; FLAC bit for bit; mels
in [0, 1] within 1e-5 (the FFTs of two libraries differ in rounding only);
the native mel engine within 2e-3 of the torch path (tests/test_native.py's
gate for dvc_tpu's engine against its JAX path)."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.data import preprocess as jpre
from dvc_tpu.ops import audio as jaudio
from dvc_tpu.utils import wavio as jwavio
from dvc_tpu_torch.data import preprocess as ppre
from dvc_tpu_torch.ops import audio as paudio
from dvc_tpu_torch.utils import wavio as pwavio
from tools.flac_encoder import write_flac

SR = 16_000
ELEM_ATOL = 2.4e-7
MEL_ATOL = 1e-5
NATIVE_MEL_ATOL = 2e-3


def utterance(seed: int, sr: int = SR, seconds: float = 2.0, noise: float = 0.003) -> np.ndarray:
    """A voiced utterance: harmonics of a moving f0 (1/h amplitudes up to
    7.9 kHz) in three segments, 0.5-1 s silent gaps between them, and a
    white noise floor."""
    r = np.random.RandomState(seed)
    parts = []
    for k in range(3):
        n = int(sr * seconds / 3)
        t = np.arange(n) / sr
        f0 = 110 + 15 * seed + 25 * np.sin(2 * np.pi * (0.5 + 0.2 * k) * t)
        ph = 2 * np.pi * np.cumsum(f0) / sr
        v = sum((0.3 / h) * np.sin(h * ph + r.rand() * 6.28) * (f0 * h < 7900)
                for h in range(1, 60))
        parts += [v * np.hanning(n) ** 0.1, np.zeros(int(sr * r.uniform(0.5, 1.0)))]
    w = np.concatenate(parts)
    return (w + noise * r.randn(len(w))).astype(np.float32)


# --- the audio ops -------------------------------------------------------------

def test_volume_rescale_mulaw():
    rng = np.random.RandomState(0)
    x = (rng.randn(4000) * 0.2).astype(np.float32)
    quiet = x * 0.01
    for wav in (x, quiet):
        for kw in ({}, {"increase_only": True}, {"decrease_only": True}):
            want = np.asarray(jaudio.normalize_volume(jnp.asarray(wav), -30.0, **kw))
            got = paudio.normalize_volume(torch.from_numpy(wav), -30.0, **kw).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=ELEM_ATOL)
    with pytest.raises(ValueError):
        paudio.normalize_volume(torch.from_numpy(x), increase_only=True, decrease_only=True)
    np.testing.assert_allclose(paudio.rescale_wav(torch.from_numpy(x)).numpy(),
                               np.asarray(jaudio.rescale_wav(jnp.asarray(x))), atol=ELEM_ATOL)
    y = np.clip(x * 4, -1, 1)
    for fn in ("mulaw", "inv_mulaw"):
        np.testing.assert_allclose(getattr(paudio, fn)(torch.from_numpy(y)).numpy(),
                                   np.asarray(getattr(jaudio, fn)(jnp.asarray(y))),
                                   atol=ELEM_ATOL)
    back = paudio.inv_mulaw(paudio.mulaw(torch.from_numpy(y))).numpy()
    np.testing.assert_allclose(back, y, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vad_masks_and_trim_equal(seed):
    """Both detectors' per-window masks equal dvc_tpu's, and so does the
    trimmed waveform; the utterance's silent gaps are trimmed."""
    w = utterance(seed, seconds=2.4)
    for mode in (3, 0):
        want = np.asarray(jaudio.gmm_vad_mask(jnp.asarray(w), mode=mode))
        got = paudio.gmm_vad_mask(torch.from_numpy(w), mode=mode).numpy()
        np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)
    for thr in (-48.0, -30.0):
        np.testing.assert_array_equal(
            paudio.energy_vad_mask(torch.from_numpy(w), threshold_db=thr).numpy(),
            np.asarray(jaudio.energy_vad_mask(jnp.asarray(w), threshold_db=thr)))
    for det in ("gmm", "energy"):
        want = jaudio.trim_long_silences(w, SR, detector=det)
        got = paudio.trim_long_silences(w, SR, detector=det)
        np.testing.assert_array_equal(got, want)
        assert len(got) < len(w)


# --- reading audio -------------------------------------------------------------

def test_read_audio_wav_flac_m4a(tmp_path):
    """wav and FLAC (16-bit and 24-bit frames, stereo) read bit for bit as
    dvc_tpu reads them; an m4a fails as dvc_tpu's does."""
    w = utterance(3, sr=22050, seconds=1.0)
    pwavio.write_wav(str(tmp_path / "a.wav"), w, 22050)
    write_flac(str(tmp_path / "a.flac"), w, 22050)
    write_flac(str(tmp_path / "b.flac"), np.stack([w, -0.5 * w], 1), 44100, frame_bps=24)
    for name in ("a.wav", "a.flac", "b.flac"):
        got, sr = pwavio.read_audio(str(tmp_path / name))
        want, sr_want = jwavio.read_audio(str(tmp_path / name))
        assert sr == sr_want and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    (tmp_path / "c.m4a").write_bytes(b"\x00" * 64)
    errs = []
    for mod in (pwavio, jwavio):
        with pytest.raises((NotImplementedError, RuntimeError)) as e:
            mod.read_audio(str(tmp_path / "c.m4a"))
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    if shutil.which("ffmpeg") is None:
        assert errs[0][0] is NotImplementedError and "ffmpeg" in errs[0][1]


def test_mel_extractor_backends():
    """The torch backend against dvc_tpu's JAX extractor; the native engine
    against the torch path and, bit for bit, against dvc_tpu's engine (the
    same C++ source built with the same flags)."""
    rng = np.random.RandomState(3)
    wavs = [(rng.randn(n) * 0.1).astype(np.float32) for n in (5000, 12000, 17000, 40000)]
    want = jpre.BatchedMelExtractor(batch_size=3)(wavs)
    got = ppre.BatchedMelExtractor(batch_size=3, device="cpu")(wavs)
    nat = ppre.BatchedMelExtractor(backend="native", device="cpu")(wavs)
    jnat = jpre.BatchedMelExtractor(backend="native")(wavs)
    for w, g, n, jn in zip(want, got, nat, jnat):
        assert g.shape == w.shape == n.shape
        np.testing.assert_allclose(g, w, atol=MEL_ATOL)
        np.testing.assert_allclose(n, g, atol=NATIVE_MEL_ATOL)
        np.testing.assert_array_equal(n, jn)
    with pytest.raises(ValueError):
        ppre.BatchedMelExtractor(backend="jax", device="cpu")


# --- preprocess_dataset ----------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """VCTK layout: 2 speakers x 3 utterances of 1.3-2.2 s of voice plus
    their gaps, one at 22.05 kHz and one at 48 kHz (both resampled)."""
    root = tmp_path_factory.mktemp("corpus")
    rates = {("p225", 1): 22050, ("p226", 2): 48000}
    for si, spk in enumerate(("p225", "p226")):
        d = root / "VCTK-Corpus" / "wav16" / spk
        d.mkdir(parents=True)
        for u in range(3):
            sr = rates.get((spk, u), SR)
            w = utterance(10 * si + u, sr=sr, seconds=1.3 + 0.45 * u)
            pwavio.write_wav(str(d / f"{spk}_{u:03d}.wav"), w, sr)
    return root


@pytest.mark.parametrize("trim", [False, True], ids=["no_trim", "trim"])
def test_preprocess_dataset_against_dvc_tpu(corpus, tmp_path, trim):
    jout, pout = tmp_path / "jax", tmp_path / "port"
    js = jpre.preprocess_dataset(str(corpus), str(jout), "VCTK", trim=trim, batch_size=4)
    ps = ppre.preprocess_dataset(str(corpus), str(pout), "VCTK", trim=trim, batch_size=4,
                                 device="cpu")
    assert (ps.n_files, ps.n_skipped, ps.n_frames, ps.n_samples) == \
        (js.n_files, js.n_skipped, js.n_frames, js.n_samples) and ps.n_files == 6
    for spk in ("p225", "p226"):
        assert (pout / spk / "_sources.txt").read_text() == (jout / spk / "_sources.txt").read_text()
        names = sorted(os.listdir(jout / spk))
        assert sorted(os.listdir(pout / spk)) == names
        for n in names:
            if n.endswith(".npy"):
                a, b = np.load(pout / spk / n), np.load(jout / spk / n)
                assert a.shape == b.shape and a.shape[0] == 80 and a.dtype == np.float32
                assert a.min() >= 0 and a.max() <= 1
                np.testing.assert_allclose(a, b, atol=MEL_ATOL, err_msg=n)


def test_preprocess_skip_existing_appends(corpus, tmp_path):
    """A rerun with skip_existing leaves a complete manifest alone and
    appends only the utterances it lacks."""
    out = tmp_path / "mels"
    ppre.preprocess_dataset(str(corpus), str(out), "VCTK", device="cpu")
    src = out / "p225" / "_sources.txt"
    full = src.read_text()
    again = ppre.preprocess_dataset(str(corpus), str(out), "VCTK", skip_existing=True,
                                    device="cpu")
    assert (again.n_files, again.n_skipped) == (0, 6) and src.read_text() == full
    lines = full.splitlines(keepends=True)
    src.write_text("".join(lines[:-1]))
    os.remove(out / "p225" / lines[-1].split(",")[0])
    again = ppre.preprocess_dataset(str(corpus), str(out), "VCTK", skip_existing=True,
                                    device="cpu")
    assert (again.n_files, again.n_skipped) == (1, 5) and src.read_text() == full
