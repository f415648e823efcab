"""Port parity of the tools/ Pallas probes (P1 bench_taps, P2/P3 bench_body
resident/streamed, P4 bench_body2 stages 0-4): each plain twin in
dvc_tpu_torch.tools against the JAX probe run in TPU interpret mode on the
CPU, with the JAX module's constants narrowed by monkeypatch (L=4, R=G=64,
S=32, C=16, B=2, T=20; BUF stays 504 >= sum 2d).  Errors are max |port -
jax| over max |jax|: float32 (P1) 1e-5, the bf16 paths 2e-2."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dvc_tpu_torch.tools import _common, ablate_body, bench_body, bench_body2, bench_taps
from dvc_tpu_torch.utils.convert import probe_weights_from_jax

TOOLS = Path(__file__).resolve().parents[1] / "tools"
NARROW = dict(B=2, R=64, G=64, S=32, C=16, T=20, L=4)
F32_TOL, BF16_TOL = 1e-5, 2e-2


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_taps(monkeypatch):
    mod = _load("bench_taps")
    for k in ("B", "R", "T"):
        monkeypatch.setattr(mod, k, NARROW[k])
    monkeypatch.setattr(mod, "LAYERS", NARROW["L"])
    return mod


def _narrow(monkeypatch, name):
    mod = _load(name)
    for k, v in NARROW.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(mod, "G2", NARROW["G"] // 2)
    return mod


@pytest.fixture
def jax_body(monkeypatch):
    return _narrow(monkeypatch, "bench_body")


@pytest.fixture
def jax_body2(monkeypatch):
    return _narrow(monkeypatch, "bench_body2")


def _run(build):
    """build() -> the JAX probe's callable, made and called in interpret
    mode (pallas_call takes the mode when it is made)."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(build()())


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _dil():
    return _common.geometry(NARROW["L"])[0]


def _sizes(*keys):
    return {k: NARROW[k] for k in keys}


# --- P1 ---------------------------------------------------------------------

@pytest.mark.parametrize("gain", [None, 0.3], ids=["probe-w", "gain-0.3"])
@pytest.mark.parametrize("mode", bench_taps.MODES)
def test_taps_plain_matches_jax(jax_taps, mode, gain):
    """The probe's own w, and a w of larger gain (0.3 / sqrt(R) per entry),
    given to both through the JAX callable's partial arguments, where the
    probe's own w underflows (compute: exactly 0 at T = 20)."""
    if gain is None:
        w = bench_taps.default_w(NARROW["R"])
        np.testing.assert_array_equal(w, np.asarray(jax_taps.make(mode).args[2]))
        want = _run(lambda: jax_taps.make(mode))
    else:
        w = (np.random.RandomState(1).randn(NARROW["R"], NARROW["R"]) * gain
             / np.sqrt(NARROW["R"])).astype(np.float32)

        def build():
            f = jax_taps.make(mode)
            return lambda: f.func(*f.args[:2], jnp.asarray(w))
        want = _run(build)
    got = bench_taps.taps_plain(mode, torch.from_numpy(w), B=NARROW["B"], T=NARROW["T"],
                                dil=_dil()).numpy()
    assert got.shape == want.shape == (1, NARROW["B"], NARROW["R"])
    if np.abs(want).max() == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) < F32_TOL


def test_taps_make_on_cpu_matches_plain():
    kw = dict(B=2, R=32, T=5, layers=3)
    got = bench_taps.make("dynamic", device="cpu", **kw)()
    want = bench_taps.taps_plain("dynamic", torch.from_numpy(bench_taps.default_w(32)), B=2,
                                 T=5, dil=_common.geometry(3)[0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- P2, P3 -----------------------------------------------------------------

def _port_weights():
    return bench_body.weights(**_sizes("R", "G", "S", "C"), layers=NARROW["L"])


def test_probe_weights_bridge_bit_equal(jax_body, jax_body2):
    """probe_weights_from_jax turns the JAX probes' arrays into torch
    tensors of the same bits, and the port's draws equal them."""
    tree = jax_body._weights(np.random.RandomState(0))
    got = probe_weights_from_jax(tree)
    mine = _port_weights()
    assert set(got) == set(mine)
    for k, v in tree.items():
        a = np.asarray(v)
        assert got[k].dtype == (torch.bfloat16 if k != "b" else torch.float32)
        bits = got[k].view(torch.int16) if got[k].dtype == torch.bfloat16 else got[k]
        ref = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(bits.numpy(), ref)
        assert torch.equal(got[k], mine[k])
    f = jax_body2.make(4)
    names = ("w_dil", "w_c", "w_skip", "w_out", "b_dil", "w_first", "w_f1", "w_f2")
    tree2 = dict(zip(("cond_in",) + names, f.args[2:]))
    got2 = probe_weights_from_jax(tree2)
    mine2 = bench_body2.weights(**_sizes("B", "R", "G", "S", "C", "T"), layers=NARROW["L"])
    for k in tree2:
        assert got2[k].dtype == mine2[k].dtype and torch.equal(got2[k], mine2[k]), k


@pytest.mark.parametrize("which", ["resident", "streamed"])
def test_body_plain_matches_jax(jax_body, which):
    want = _run(getattr(jax_body, f"make_{which}"))
    plain = getattr(bench_body, f"{which}_plain")
    got, skip = plain(_port_weights(), B=NARROW["B"], T=NARROW["T"], dil=_dil())
    assert got.shape == want.shape and skip.shape == (NARROW["B"], NARROW["S"])
    assert _rel(got.numpy(), want) < BF16_TOL
    assert torch.isfinite(skip).all() and skip.abs().max() > 0


def test_resident_and_streamed_differ(jax_body):
    """P2 takes cond once per step, P3 at every layer: the two outputs
    differ, in JAX and in the port, and by the same amount."""
    j2 = _run(jax_body.make_resident)
    j3 = _run(jax_body.make_streamed)
    w, kw = _port_weights(), dict(B=NARROW["B"], T=NARROW["T"], dil=_dil())
    p2 = bench_body.resident_plain(w, **kw)[0].numpy()
    p3 = bench_body.streamed_plain(w, **kw)[0].numpy()
    jd, pd = j2 - j3, p2 - p3
    assert np.abs(jd).max() > 1e-3 * np.abs(j2).max()
    assert np.abs(pd).max() > 1e-3 * np.abs(p2).max()
    assert _rel(pd, jd) < 0.1
    # the wrappers on the CPU take each rule: swapping them swaps the outputs
    swapped = bench_body.resident(w, cond_rule="layer", **kw)[0].numpy()
    np.testing.assert_array_equal(swapped, p3)


def test_body_make_on_cpu_matches_plain():
    kw = dict(B=2, R=32, G=32, S=16, C=8, T=3, layers=3)
    got = bench_body.make_streamed(device="cpu", **kw)()
    w = bench_body.weights(R=32, G=32, S=16, C=8, layers=3)
    want, _ = bench_body.streamed_plain(w, B=2, T=3, dil=_common.geometry(3)[0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pack_layout():
    """The kernel's output-major pack holds the probe's columns."""
    w = _port_weights()
    p = bench_body.pack(w)
    R, C, S, G2 = NARROW["R"], NARROW["C"], NARROW["S"], NARROW["G"] // 2
    L, G = NARROW["L"], NARROW["G"]
    assert p["w_in"].shape == (L, G, 3 * R + C + (-(3 * R + C) % 8))
    j = 5
    want = torch.cat([w["w_dil"][2, 0, :, j], w["w_dil"][2, 1, :, j], w["w_dil"][2, 2, :, j],
                      w["w_c"][2, :, j]])
    assert torch.equal(p["w_in"][2, j, :3 * R + C], want)
    assert torch.equal(p["w_so"][1, 3], w["w_skip"][1, :, 3])
    assert torch.equal(p["w_so"][1, S + 7], w["w_out"][1, :, 7])
    assert p["w_so"].shape == (L, S + R, G2)


# --- P4 ---------------------------------------------------------------------

@pytest.mark.parametrize("stage", bench_body2.STAGES)
def test_body2_plain_matches_jax(jax_body2, stage):
    want = _run(lambda: jax_body2.make(stage))
    w = bench_body2.weights(**_sizes("B", "R", "G", "S", "C", "T"), layers=NARROW["L"])
    got, skip = bench_body2.body2_plain(w, stage, B=NARROW["B"], T=NARROW["T"], dil=_dil())
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < BF16_TOL
    assert torch.isfinite(skip).all()


# --- the ablation's edits of the kernel source ------------------------------

@pytest.mark.parametrize("name", list(ablate_body.VARIANTS))
def test_ablation_edits_match_the_source(name):
    """Each variant's edits match csrc/probe_body.cu once each, so a kernel
    edit that outgrows them fails here and not on the card."""
    src = ablate_body.variant_source(name)
    assert (src == ablate_body.SOURCE.read_text()) == (name == "base")


# --- no card ------------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda: bench_taps.make("dynamic"),
    lambda: bench_taps.bench("static", T=1),
    lambda: bench_body.make_resident(),
    lambda: bench_body.make_streamed(),
    lambda: bench_body2.make(3),
    lambda: bench_body2.bench(0, T=1),
    lambda: bench_taps.main([]),
    lambda: bench_body.main(["resident"]),
    lambda: bench_body2.main(["4"]),
    lambda: ablate_body.main([]),
], ids=["taps-make", "taps-bench", "resident", "streamed", "body2-make", "body2-bench",
        "taps-main", "body-main", "body2-main", "ablate-main"])
def test_cuda_without_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()
