"""The MCD slice of the port against dvc_tpu on the CPU: freqt's matrix
against dvc_tpu's recursion, sp2mc, CheapTrick, world_decompose (Harvest
and D4C in the port's own copy of the C++ engine), DTW, and per-utterance
MCD.

CheapTrick's smoothing (dvc_tpu/ops/world.py:257-271) differences a
cumulative sum of the frame's power spectrum.  dvc_tpu keeps that sum in
float32, whose resolution is about 6e-8 of the frame's total power, so
where a band holds less power than that the envelope is rounding noise,
and two float32 implementations disagree there (on `utterance(1, 0.003)`
below, dvc_tpu's envelope is e^37.8 off a float64 evaluation of the same
formula).  The port keeps the sum in float64.  So the port is held:
  * against a float64 CheapTrick written here, on a harmonic input with a
    -50 dB noise floor, within 1e-4 in log power (measured 3.8e-5);
  * against dvc_tpu on inputs whose every band is above dvc_tpu's float32
    resolution (a noise floor of 0.1, where dvc_tpu itself is within 1e-2
    of float64 in log power, 6.7e-3 measured): CheapTrick no further from
    dvc_tpu than dvc_tpu's own error plus 1e-4, the MCCs within 1e-4
    (1.6e-5 measured), f0 and aperiodicity equal, MCD within 1e-3 dB
    (1.3e-6 measured);
  * freqt and sp2mc on the same inputs: within 1e-5 of the output's max.
"""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvc_tpu.native
from dvc_tpu.eval import mcd as jmcd
from dvc_tpu.ops import world as jworld
from dvc_tpu_torch.cli import run as cli
from dvc_tpu_torch.eval import mcd as pmcd
from dvc_tpu_torch.ops import world as pworld
from dvc_tpu_torch.utils.wavio import write_wav

SR = 16_000
REL_MAX = 1e-5      # freqt / sp2mc: float32 scan against a float64 matrix
F64_LOG_ATOL = 1e-4  # the port's CheapTrick against float64, in log power
ENV_LOG_ATOL = 1e-2  # dvc_tpu's CheapTrick against float64 where it resolves every band
MCC_ATOL = 1e-4
MCD_ATOL = 1e-3     # dB


def utterance(seed: int, noise: float, seconds: float = 2.0) -> np.ndarray:
    """Harmonics of a moving f0 (1/h amplitudes up to 7.9 kHz), a 0.5 s
    silent gap, and a white noise floor of std ``noise``."""
    r = np.random.RandomState(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t + seed) + 10 * seed
    ph = 2 * np.pi * np.cumsum(f0) / SR
    v = sum((0.3 / h) * np.sin(h * ph + r.rand() * 6.28) * (f0 * h < 7900)
            for h in range(1, 80))
    v[int(0.8 * SR):int(1.3 * SR)] = 0
    return (v + noise * r.randn(n)).astype(np.float32)


def cheaptrick_f64(wav, f0, fs=SR, frame_period=5.0):
    """The formula of dvc_tpu's spectral_envelope evaluated in float64."""
    fft = pworld.cheaptrick_fft_size(fs)
    nf, hop, n = fft // 2 + 1, int(fs * frame_period / 1000), len(f0)
    f0s = np.where(f0 > 0, f0, pworld.DEFAULT_F0)
    hw = np.minimum((1.5 * fs / f0s).astype(int), fft // 2 - 1)[:, None].astype(float)
    pad = np.pad(wav.astype(np.float64), (fft // 2, fft))
    segs = pad[np.arange(n)[:, None] * hop + np.arange(fft)[None]]
    t = (np.arange(fft) - fft // 2)[None].astype(float)
    win = np.where(np.abs(t) <= hw, 0.5 + 0.5 * np.cos(np.pi * t / hw), 0.0)
    win /= np.sqrt((win ** 2).sum(-1, keepdims=True))
    spec = np.abs(np.fft.rfft(segs * win, axis=-1)) ** 2
    wb = np.maximum(2 / 3 * f0s / (fs / fft), 1.0)[:, None]
    cs = np.cumsum(np.pad(spec, ((0, 0), (1, 0))), -1)
    k = np.arange(nf)[None].astype(float)
    lo, hi = np.clip(k - wb / 2, 0, nf - 1), np.clip(k + wb / 2, 0, nf - 1)

    def at(pos):
        i0 = np.floor(pos).astype(int)
        fr = pos - i0
        return (np.take_along_axis(cs, i0, -1) * (1 - fr)
                + np.take_along_axis(cs, np.minimum(i0 + 1, nf), -1) * fr)

    sm = np.maximum((at(hi) - at(lo)) / np.maximum(hi - lo, 1e-6), 1e-30)
    ls = np.log(sm)
    ceps = np.fft.rfft(np.concatenate([ls, ls[:, -2:0:-1]], -1), axis=-1).real / fft * 2
    f0q = f0s[:, None] * np.arange(ceps.shape[-1])[None] / fs
    sinc = np.where(f0q == 0, 1.0, np.sin(np.pi * f0q) / np.maximum(np.pi * f0q, 1e-12))
    comp = (1 - 2 * pworld.Q1) + 2 * pworld.Q1 * np.cos(2 * np.pi * f0q)
    return np.exp(np.fft.irfft(ceps * sinc * comp, n=fft, axis=-1)[:, :nf] * fft / 2)


@pytest.mark.parametrize("n_in,order,alpha", [(513, 35, 0.41), (513, 23, 0.42),
                                              (37, 512, -0.41), (5, 3, 0.3)])
def test_freqt_matrix_against_scan(n_in, order, alpha):
    c = np.random.RandomState(n_in + order).randn(6, n_in).astype(np.float32)
    want = np.asarray(jworld.freqt(jnp.asarray(c), order, alpha))
    got = pworld.freqt(torch.from_numpy(c), order, alpha).numpy()
    assert got.shape == want.shape == (6, order + 1)
    assert np.abs(got - want).max() <= REL_MAX * np.abs(want).max()


def test_mcepalpha_and_fft_size():
    for fs in (8000, 16000, 22050, 44100):
        assert pworld.mcepalpha(fs) == jworld.mcepalpha(fs)
        assert pworld.cheaptrick_fft_size(fs) == jworld.cheaptrick_fft_size(fs)


def test_sp2mc_on_the_same_envelope():
    w = utterance(0, 0.1)
    f0 = np.full(len(w) // 80 + 1, 140.0, np.float32)
    sp = np.array(jworld.spectral_envelope(jnp.asarray(w), jnp.asarray(f0)))
    want = np.asarray(jworld.sp2mc(jnp.asarray(sp), 35, jworld.mcepalpha(SR)))
    got = pworld.sp2mc(torch.from_numpy(sp), 35, pworld.mcepalpha(SR)).numpy()
    assert np.abs(got - want).max() <= REL_MAX * np.abs(want).max()


def _f0_track(n):
    f0 = (130 + 20 * np.sin(np.arange(n) / 30.0)).astype(np.float32)
    f0[n // 3:n // 2] = 0  # unvoiced frames take DEFAULT_F0
    return f0


def test_spectral_envelope_against_float64():
    """On a harmonic input with a -50 dB floor, where dvc_tpu's float32 sum
    is rounding noise in the upper bands (more than e^10 off float64 in
    power; 37.8 in log measured), the port holds float64 (3.8e-5 measured)."""
    w = utterance(1, 0.003)
    f0 = _f0_track(len(w) // 80 + 1)
    got = pworld.spectral_envelope(torch.from_numpy(w), torch.from_numpy(f0)).numpy()
    ref = np.log(cheaptrick_f64(w, f0.astype(np.float64)))
    assert got.shape == ref.shape == (len(f0), 513)
    assert np.abs(np.log(got) - ref).max() <= F64_LOG_ATOL
    dvc = np.asarray(jworld.spectral_envelope(jnp.asarray(w), jnp.asarray(f0)))
    assert np.abs(np.log(dvc) - ref).max() > 10.0  # the regime this test is for


def test_spectral_envelope_against_dvc_tpu():
    """Where every band is above dvc_tpu's float32 resolution, the port is
    no further from dvc_tpu than dvc_tpu's own float32 error (against
    float64) plus the port's limit against float64."""
    w = utterance(2, 0.1)
    f0 = _f0_track(len(w) // 80 + 1)
    want = np.asarray(jworld.spectral_envelope(jnp.asarray(w), jnp.asarray(f0)))
    got = pworld.spectral_envelope(torch.from_numpy(w), torch.from_numpy(f0)).numpy()
    ref = np.log(cheaptrick_f64(w, f0.astype(np.float64)))
    assert got.shape == want.shape == ref.shape
    dvc_err = np.abs(np.log(want) - ref).max()
    assert dvc_err <= ENV_LOG_ATOL
    assert np.abs(np.log(got) - ref).max() <= F64_LOG_ATOL
    assert np.abs(np.log(got) - np.log(want)).max() <= dvc_err + F64_LOG_ATOL


@pytest.mark.parametrize("seed,seconds", [(3, 2.0), (4, 1.37)])
def test_world_decompose(seed, seconds):
    """The native route: f0, time axis and aperiodicity equal (the same C++
    engine), the envelope and MCCs at the limits above, the frame count
    len // hop + 1 at a length that is not a multiple of the hop."""
    w = utterance(seed, 0.1, seconds)
    want = jworld.world_decompose(w, SR)
    got = pworld.world_decompose(w, SR, device="cpu")
    f0, ta, sp, ap, mc = got
    assert len(f0) == len(w) // 80 + 1 and mc.shape == (len(f0), 36)
    np.testing.assert_array_equal(f0, want[0])
    np.testing.assert_array_equal(ta, want[1])
    np.testing.assert_array_equal(ap, want[3])
    assert (f0 > 0).sum() > len(f0) // 2
    bucket = -(-(len(w) + 1) // 8000) * 8000  # world_decompose's pad_to
    ref = np.log(cheaptrick_f64(np.pad(w, (0, bucket - len(w))),
                                np.pad(f0, (0, bucket // 80 + 1 - len(f0))).astype(np.float64)))
    ref = ref[:len(f0)]
    dvc_err = np.abs(np.log(want[2]) - ref).max()
    assert dvc_err <= ENV_LOG_ATOL
    assert np.abs(np.log(sp) - np.log(want[2])).max() <= dvc_err + F64_LOG_ATOL
    np.testing.assert_allclose(mc, want[4], atol=MCC_ATOL, rtol=0)


def test_dtw_path_equal(monkeypatch):
    """The native DTW's path equals dvc_tpu's Python recurrence's."""
    rng = np.random.RandomState(7)
    cases = [(rng.randn(40, 24), rng.randn(55, 24)), (rng.randn(1, 3), rng.randn(9, 3))]
    x = rng.randn(30, 24)
    cases.append((x, x[np.sort(rng.randint(0, 30, 45))] + 0.01 * rng.randn(45, 24)))
    monkeypatch.setattr(dvc_tpu.native, "available", lambda: False)
    for a, b in cases:
        px, py = pmcd.dtw_path(a, b)
        jx, jy = jmcd.dtw_path(a, b)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


def test_mcd_from_mcc_edge_cases():
    """Without f0, with voiced frames, and with a side that has none (both
    fall back to all frames); an empty sequence gives nan."""
    rng = np.random.RandomState(8)
    a, b = rng.randn(20, 36), rng.randn(25, 36)
    f_a, f_b = np.where(rng.rand(20) > 0.5, 120.0, 0.0), np.where(rng.rand(25) > 0.3, 90.0, 0.0)
    for args in ((a, b), (a, b, f_a, f_b), (a, b, f_a, np.zeros(25))):
        assert pmcd.mcd_from_mcc(*args) == pytest.approx(jmcd.mcd_from_mcc(*args), abs=1e-12)
    assert np.isnan(pmcd.mcd_from_mcc(a[:0], b)) and np.isnan(jmcd.mcd_from_mcc(a[:0], b))


def test_evaluate_mcd_wav_against_dvc_tpu():
    """Per-utterance MCD on synthetic pairs within 1e-3 dB of dvc_tpu's, and
    exactly 0.0 for identical wavs; the thread pool is used (4 pairs).  The
    batched device analysis (world_decompose_batch) within 1e-3 dB of
    dvc_tpu's device analysis, 0.0 for identical wavs too."""
    src = [utterance(s, 0.1, 1.5) for s in (5, 6, 7)]
    trg = [utterance(s + 10, 0.1, 1.5 + 0.1 * s) for s in (5, 6)] + [src[2]]
    want = jmcd.evaluate_mcd_wav(src, trg)
    got = pmcd.evaluate_mcd_wav(src, trg, device="cpu")
    assert got[2] == 0.0 and want[2] == 0.0
    assert all(m > 0.5 for m in got[:2])
    np.testing.assert_allclose(got, want, atol=MCD_ATOL, rtol=0)
    dev = pmcd.evaluate_mcd_wav(src, trg, analysis="device", device="cpu")
    assert dev[2] == 0.0
    np.testing.assert_allclose(dev, jmcd.evaluate_mcd_wav(src, trg, analysis="device"),
                               atol=MCD_ATOL, rtol=0)


def test_cli_eval_mcd(tmp_path, capsys):
    """eval-mcd pairs converter-named and _cv-named wavs to their sources
    as dvc_tpu's command does, prints each MCD and the mean; sources
    against themselves give 0.0; --analysis device prints the MCDs of
    evaluate_mcd_wav(analysis="device") for the same pairs."""
    src, cvt = tmp_path / "src", tmp_path / "cvt" / "p1_to_p2"
    (src / "p1").mkdir(parents=True)
    cvt.mkdir(parents=True)
    for i in range(2):
        w = utterance(20 + i, 0.1, 1.2)
        write_wav(str(src / "p1" / f"p1_{i:03d}.wav"), w)
        write_wav(str(cvt / f"convert_p1_to_p2_{i:03d}.wav"), utterance(30 + i, 0.1, 1.3))
    write_wav(str(cvt / "p1_001_cv.wav"), utterance(21, 0.1, 1.2))
    pairs = cli._pair_converted_to_source(str(src), str(tmp_path / "cvt"))
    from dvc_tpu.cli.run import _pair_converted_to_source as jpair
    assert pairs == jpair(str(src), str(tmp_path / "cvt")) and len(pairs) == 3
    assert cli.main(["eval-mcd", "--src_dir", str(src), "--cvt_dir", str(tmp_path / "cvt"),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    mcds = {ln.split()[1]: float(ln.split("mcd: ")[1]) for ln in out if "mcd:" in ln}
    assert mcds["p1_001_cv.wav"] == 0.0 and mcds["convert_p1_to_p2_000.wav"] > 0
    assert out[-1].startswith("MCD value between two speaker: ")
    assert cli.main(["eval-mcd", "--src_dir", str(src), "--cvt_dir", str(tmp_path / "cvt"),
                     "--analysis", "device", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    dev = {ln.split()[1]: float(ln.split("mcd: ")[1]) for ln in out if "mcd:" in ln}
    assert dev.keys() == mcds.keys() and dev["p1_001_cv.wav"] == 0.0
    from dvc_tpu_torch.utils.wavio import read_wav
    want = pmcd.evaluate_mcd_wav([read_wav(a)[0] for a, _ in pairs],
                                 [read_wav(b)[0] for _, b in pairs], analysis="device",
                                 device="cpu")
    assert [dev[os.path.basename(b)] for _, b in pairs] == pytest.approx(want, abs=1e-9)
