"""Port parity of the tools/ Pallas probes (P1 bench_taps, P2/P3 bench_body
resident/streamed, P4 bench_body2 stages 0-4): each plain twin in
dvc_tpu_torch.tools against the JAX probe run in TPU interpret mode on the
CPU, with the JAX module's constants narrowed by monkeypatch (L=4, R=G=64,
S=32, C=16, B=2, T=20; BUF stays 504 >= sum 2d).  Errors are max |port -
jax| over max |jax|: float32 (P1) 1e-5, the bf16 paths 2e-2.

What the kernels' host side plans, which the CPU can hold: P1's cluster
plan, body_mma's (P2, P4) tile and shared-memory plan and P3's (two
kernels, a block of each on one SM), their constants against the .cu
sources, P3's launch chain in the source (programmatic dependent launch
from a CUDA graph, nothing written in the call read before the wait), and
the fragment pack that body_mma and P3 read, unpacked bit for bit and
multiplied out lane by lane as mma.m16n8k16 reads it."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dvc_tpu_torch.tools import (_common, ablate_body, bench_body, bench_body2, bench_sync,
                                  bench_taps)
from dvc_tpu_torch.utils.convert import probe_weights_from_jax

TOOLS = Path(__file__).resolve().parents[1] / "tools"
CSRC = Path(__file__).resolve().parents[1] / "dvc_tpu_torch" / "kernels" / "csrc"
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


# the narrowest widths body_mma takes (128 blocks: one gate pair, one skip
# row, one channel of h and one final1 column a block)
FRAG = dict(R=128, G=256, S=128, C=16)


def test_pack_layout():
    """The kernels' pack: the bias as (L, G) and, where the kernels' tiles
    take the widths, body_mma's fragment pack (P2, P4), which unpacks to
    the weights bit for bit, and P3's (test_streamed_pack_multiplies_out),
    under names that leave the weights beside them alone (at the probes'
    narrow test widths no fragments are made: the plain twins run there)."""
    frag_w = bench_body.weights(**FRAG, layers=3)
    p = bench_body.pack(frag_w)
    frag = p["w_frag"]
    plan = bench_body.body_plan(8, 3, 128, 256, 128, 16)
    assert frag.dtype == torch.bfloat16
    assert frag.shape == (3, bench_body.CTAS, plan["layer_bytes"] // 2)
    back = bench_body.frag_unpack(frag, 128, 256, 128, 16)
    for k, v in back.items():
        assert torch.equal(v.view(torch.int16), frag_w[k].view(torch.int16)), k
    assert not set(p) & set(frag_w)  # prepare() puts the pack beside the weights
    assert set(p) == {"b_in", "w_frag", "streamed_in", "streamed_out"}
    assert p["b_in"].dtype == torch.float32 and p["b_in"].shape == (3, FRAG["G"])
    assert torch.equal(p["b_in"], frag_w["b"].reshape(3, FRAG["G"]))
    w = _port_weights()
    assert set(bench_body.pack(w)) == {"b_in"}


def _mma_rows(frag: torch.Tensor, rows: int, k: int, x: torch.Tensor) -> torch.Tensor:
    """D = A x^T of one block's tile as mma.m16n8k16 computes it from the
    fragments: at k-step kk lane (g, t) holds A[g][16kk + 2t, + 1] in its
    first register and A[g][16kk + 8 + 2t, + 1] in its third, and the batch
    column n's lane supplies x[n][16kk + 2t, + 1] and [.. + 8, + 9] (PTX ISA,
    the m16n8k16 .bf16 fragment layouts).  x (n, K) -> (rows, n), float64."""
    f = frag.double().reshape(k // 16, rows, 4, 4)
    xd = x.double()
    d = torch.zeros(rows, x.shape[0], dtype=torch.float64)
    for kk in range(k // 16):
        for g in range(rows):
            for t in range(4):
                a0, a1, a4, a5 = f[kk, g, t]
                c0 = 16 * kk + 2 * t
                d[g] += (a0 * xd[:, c0] + a1 * xd[:, c0 + 1] + a4 * xd[:, c0 + 8]
                         + a5 * xd[:, c0 + 9])
    return d


def test_frag_pack_multiplies_out_as_the_matmul():
    """Block i's fragments of a layer, read lane by lane as the tensor cores
    read them, give its rows of x2 @ W0 + x1 @ W1 + h @ W2 + cond @ Wc (its
    gate pairs' a- and g-columns), of gated @ [w_skip | w_out] (its skip
    rows, then its channels of h), and of final1."""
    w = bench_body.weights(**FRAG, layers=3)
    r, g, s_ch, c = FRAG["R"], FRAG["G"], FRAG["S"], FRAG["C"]
    g2, ctas = g // 2, bench_body.CTAS
    plan = bench_body.body_plan(4, 3, r, g, s_ch, c, head=True, cond_rule="input")
    rin, rout, rf1 = plan["rows_in"], plan["rows_out"], plan["rows_f1"]
    kt, kh, ko, kf = (16 * k for k in plan["k_steps"])
    frag = bench_body.frag_pack(w)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, kt + kh).astype(np.float32)).to(torch.bfloat16)
    x[:, kt + r + c:] = 0  # the h part's pad
    wcat = torch.cat([w["w_dil"][1, 0], w["w_dil"][1, 1], w["w_dil"][1, 2], w["w_c"][1]], 0)
    ref_in = x[:, :kt + r + c].double() @ wcat.double()  # (4, G)
    gated = torch.from_numpy(rng.randn(4, g2).astype(np.float32)).to(torch.bfloat16)
    ref_out = gated.double() @ torch.cat([w["w_skip"][1], w["w_out"][1]], 1).double()
    w_f1 = torch.from_numpy(rng.randn(s_ch, s_ch).astype(np.float32)).to(torch.bfloat16)
    f1 = bench_body.f1_frag_pack(w_f1)
    assert f1.shape == (ctas, plan["f1_bytes"] // 2)
    skip = torch.from_numpy(rng.randn(4, s_ch).astype(np.float32)).to(torch.bfloat16)
    ref_f1 = skip.double() @ w_f1.double()
    for i in (0, 37, ctas - 1):
        blk = frag[1, i]
        d_in = (_mma_rows(blk[:rin * kt], rin, kt, x[:, :kt])
                + _mma_rows(blk[rin * kt:rin * (kt + kh)], rin, kh, x[:, kt:]))
        cols = [i * (g2 // ctas) + p for p in range(g2 // ctas)]
        want = ref_in[:, cols + [col + g2 for col in cols]].t()
        torch.testing.assert_close(d_in, want, rtol=1e-12, atol=1e-12)
        d_out = _mma_rows(blk[rin * (kt + kh):], rout, ko, gated)
        rs, rh = s_ch // ctas, r // ctas
        cols = [i * rs + q for q in range(rs)] + [s_ch + i * rh + q for q in range(rh)]
        torch.testing.assert_close(d_out, ref_out[:, cols].t(), rtol=1e-12, atol=1e-12)
        d_f1 = _mma_rows(f1[i], rf1, kf, skip)
        torch.testing.assert_close(d_f1, ref_f1[:, i * rf1:(i + 1) * rf1].t(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("B,head,resident,smem", [
    (8, False, 10, 227552), (9, False, 8, 225888), (1, True, 10, 228576), (16, True, 8, 226912),
], ids=["B8", "B9", "B1-head", "B16-head"])
def test_body_plan_at_the_probes_widths(B, head, resident, smem):
    """body_mma's plan at R = G = 512, S = 256, C = 80, 24 layers: 4 rows in,
    6 out (2 skip, 4 of h), 2 of final1 a block, 16,000 bytes of a layer's
    fragments, as many resident layers as the shared memory holds beside
    the staging of 1 or 2 n-tiles and two streamed slots."""
    plan = bench_body.body_plan(B, 24, 512, 512, 256, 80, head=head,
                                cond_rule="input" if head else "step")
    assert (plan["ctas"], plan["rows_in"], plan["rows_out"], plan["rows_f1"]) == (128, 4, 6, 2)
    assert plan["k_steps"] == (64, 37, 16, 16) and plan["layer_bytes"] == 16000
    assert plan["f1_bytes"] == (1024 if head else 0)
    assert (plan["resident_layers"], plan["smem_bytes"]) == (resident, smem)
    assert smem <= bench_body.MAX_SMEM


@pytest.mark.parametrize("kw,why", [
    (dict(B=17), "B = 17"),
    (dict(layers=1), "1 layers"),
    (dict(g=384), "split over 128 blocks"),
    (dict(c=12), "multiple of 16"),
    (dict(head=True, cond_rule="step"), "with the head"),
    (dict(g=4096), "rows a block"),
], ids=["B", "layers", "G", "C", "head-step", "rows"])
def test_body_plan_refuses(kw, why):
    args = dict(B=8, layers=24, r=512, g=512, s=256, c=80)
    args.update(kw)
    with pytest.raises(ValueError, match=why):
        bench_body.body_plan(args.pop("B"), args.pop("layers"), args.pop("r"), args.pop("g"),
                             args.pop("s"), args.pop("c"), **args)


def _code(name):
    """A .cu source without its comments."""
    return "\n".join(ln.split("//")[0] for ln in (CSRC / name).read_text().splitlines())


def _cu_constants(name):
    return dict(re.findall(r"constexpr int (k\w+) = (\d+);", (CSRC / name).read_text()))


def test_body_plan_constants_match_kernel_source():
    found = _cu_constants("probe_body.cu")
    src = (CSRC / "probe_body.cu").read_text()
    assert int(found["kCtas"]) == bench_body.CTAS
    assert "constexpr int kMmaBlock = kThreads + 32;" in src
    assert int(found["kThreads"]) + 32 == bench_body.THREADS
    for cu, py in (("kMaxNt", "MAX_NT"), ("kMaxRows", "MAX_ROWS"), ("kPad", "PAD"),
                   ("kOwnB", "OWN_B"), ("kMaxSmem", "MAX_SMEM")):
        assert int(found[cu]) == getattr(bench_body, py), cu


def test_body_mma_runs_on_the_tensor_cores_with_bulk_copies():
    """P2 and P4 launch body_mma, whose dots are mma.sync and whose weights
    come by cp.async.bulk; the first design's body_persistent is gone."""
    src = _code("probe_body.cu")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    assert not re.search(r"\bbody_persistent\b", src) and "grid_group" not in src
    assert re.findall(r"cudaLaunchCooperativeKernel\(\(const void\*\)(\w+)", src) == ["body_mma"]


@pytest.mark.parametrize("B,nt,smem_in,smem_out", [
    (1, 1, 86032, 11408), (8, 1, 86032, 11408), (9, 2, 112144, 15632), (16, 2, 112144, 15632),
], ids=["B1", "B8", "B9", "B16"])
def test_streamed_plan_at_the_probes_widths(B, nt, smem_in, smem_out):
    """P3's plan at R = G = 512, S = 256, C = 80, 24 layers, 256 threads a
    block: streamed_in on 32 blocks of 16 rows (8 gate pairs), 51,712
    bytes of a layer's fragments a block beside partial sums of 16 rows,
    the taps and [h | cond] of nt n-tiles of 8 rows and an mbarrier;
    streamed_out on body_mma's 128 blocks of 6 rows, 3,072 bytes beside
    partial sums, gated and an mbarrier; a block of each fits on one SM
    with its reservation."""
    plan = bench_body.streamed_plan(B, 24, 512, 512, 256, 80)
    assert (plan["ctas"], plan["in_ctas"], plan["threads"]) == (128, 32, 256)
    assert (plan["rows_in"], plan["rows_out"]) == (16, 6)
    assert (plan["in_bytes"], plan["out_bytes"]) == (16 * (64 + 37) * 32, 3072)
    red16, red = 8 * bench_body.MAX_NT * 16 * 8 * 4, 8 * bench_body.MAX_NT * 64 * 4
    assert smem_in == (red16 + 8 * nt * (2 * 512 + 8) * 2 + 8 * nt * (16 * 37 + 8) * 2 + 16
                       + plan["in_bytes"])
    assert smem_out == red + 8 * nt * (256 + 8) * 2 + 16 + 3072
    assert (plan["smem_in"], plan["smem_out"]) == (smem_in, smem_out)
    assert plan["pair_smem"] == smem_in + smem_out + 2 * bench_body.RESERVED_SMEM
    assert plan["pair_smem"] <= bench_body.SM_SMEM


@pytest.mark.parametrize("kw,why", [
    (dict(B=17), "B = 17"),
    (dict(cond_rule="input"), "cond rule 'input'"),
    (dict(g=384), "split over 128 blocks"),
    (dict(g=4096), "rows a block"),
], ids=["B", "input-rule", "G", "rows"])
def test_streamed_plan_refuses(kw, why):
    args = dict(B=8, layers=24, r=512, g=512, s=256, c=80)
    args.update(kw)
    with pytest.raises(ValueError, match=why):
        bench_body.streamed_plan(args.pop("B"), args.pop("layers"), args.pop("r"),
                                 args.pop("g"), args.pop("s"), args.pop("c"), **args)


def _mma16_rows(frag: torch.Tensor, k: int, x: torch.Tensor) -> torch.Tensor:
    """D = A x^T of a 16-row tile as streamed_in's a_frag16 feeds
    mma.m16n8k16: lane (g, t) reads 8 bytes of row g and 8 of row g + 8 at
    k-step kk, registers (a0, a1, a2, a3) = (row g's first pair, row g +
    8's first pair, row g's second pair, row g + 8's second pair), and the
    tensor cores take a0 as A[g][2t, + 1], a1 as A[g + 8][2t, + 1], a2 as
    A[g][2t + 8, + 9] and a3 as A[g + 8][2t + 8, + 9] (PTX ISA).  x (n, K)
    -> (16, n), float64."""
    f = frag.double().reshape(k // 16, 16, 4, 2, 2)  # k-step, row, lane quarter, pair, element
    xd = x.double()
    d = torch.zeros(16, x.shape[0], dtype=torch.float64)
    for kk in range(k // 16):
        for g in range(8):
            for t in range(4):
                a0, a2 = f[kk, g, t]  # lo.x, lo.y
                a1, a3 = f[kk, g + 8, t]  # hi.x, hi.y
                c0 = 16 * kk + 2 * t
                for row, lo_pair, hi_pair in ((g, a0, a2), (g + 8, a1, a3)):
                    d[row] += (lo_pair[0] * xd[:, c0] + lo_pair[1] * xd[:, c0 + 1]
                               + hi_pair[0] * xd[:, c0 + 8] + hi_pair[1] * xd[:, c0 + 9])
    return d


def test_streamed_pack_multiplies_out():
    """P3's pack unpacks to the weights bit for bit; streamed_in block i's
    fragments, read as a_frag16 hands them to the tensor cores, give gate
    pairs [8i, 8i + 8)'s a-rows (tile rows 0-7) and g-rows (8-15) of x2 @ W0
    + x1 @ W1 + h @ W2 + cond @ Wc; streamed_out's are body_mma's out-tiles
    and give its rows of gated @ [w_skip | w_out]."""
    w = bench_body.weights(**FRAG, layers=2)
    r, g, s_ch, c = FRAG["R"], FRAG["G"], FRAG["S"], FRAG["C"]
    packed = bench_body.streamed_pack(w)
    plan = bench_body.streamed_plan(3, 2, r, g, s_ch, c)
    assert packed["streamed_in"].shape == (2, plan["in_ctas"], plan["in_bytes"] // 2)
    assert packed["streamed_out"].shape == (2, bench_body.CTAS, plan["out_bytes"] // 2)
    for k, v in bench_body.streamed_unpack(packed, r, g, s_ch, c).items():
        assert torch.equal(v.view(torch.int16), w[k].view(torch.int16)), k
    frag = bench_body.frag_pack(w)
    n_in = frag.shape[2] - packed["streamed_out"].shape[2]
    assert torch.equal(packed["streamed_out"], frag[..., n_in:])  # body_mma's out-tiles
    kt, kh, ko, _ = (16 * k for k in plan["k_steps"])
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, kt + kh).astype(np.float32)).to(torch.bfloat16)
    x[:, kt + r + c:] = 0
    wcat = torch.cat([w["w_dil"][1, 0], w["w_dil"][1, 1], w["w_dil"][1, 2], w["w_c"][1]], 0)
    ref = x[:, :kt + r + c].double() @ wcat.double()  # (3, G)
    g2 = g // 2
    for i in (0, 5, plan["in_ctas"] - 1):
        run = packed["streamed_in"][1, i]
        got = _mma16_rows(run[:16 * kt], kt, x[:, :kt]) + _mma16_rows(run[16 * kt:], kh, x[:, kt:])
        cols = list(range(8 * i, 8 * i + 8))
        torch.testing.assert_close(got, ref[:, cols + [q + g2 for q in cols]].t(), rtol=1e-12,
                                   atol=1e-12)
    gated = torch.from_numpy(rng.randn(3, g2).astype(np.float32)).to(torch.bfloat16)
    want = gated.double() @ torch.cat([w["w_skip"][1], w["w_out"][1]], 1).double()
    rs, rh = s_ch // 128, r // 128
    cols = [77 * rs + q for q in range(rs)] + [s_ch + 77 * rh + q for q in range(rh)]
    torch.testing.assert_close(_mma_rows(packed["streamed_out"][1, 77], plan["rows_out"], ko, gated),
                               want[:, cols].t(), rtol=1e-12, atol=1e-12)


def _kernel_body(code: str, name: str) -> str:
    """The body of ``__global__ ... name(...)`` in comment-free source."""
    start = re.search(r"__global__ void[^{;]*?\b" + name + r"\(", code).end()
    depth, i = 0, code.index("{", start)
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[i:j + 1]
    raise AssertionError(f"no body for {name}")


def test_streamed_kernels_chain_by_pdl_in_a_graph():
    """P3 is streamed_in and streamed_out launched by cudaLaunchKernelEx with
    programmatic stream serialization, captured into a CUDA graph that is
    replayed, with the constants the wrapper plans with (streamed_in's
    16-row tiles on mma's whole m16); each kernel lets
    its successor start first, brings its weights by a bulk copy before
    griddepcontrol.wait, and reads what the call writes only after it.  The
    first design's per-layer kernels and their host loop are gone."""
    found = _cu_constants("probe_body.cu")
    assert int(found["kThreads"]) == bench_body.STREAMED_THREADS
    assert int(found["kCtas"]) == bench_body.CTAS
    assert int(found["kInRows"]) == bench_body.IN_ROWS
    code = _code("probe_body.cu")
    for gone in ("body_in", "body_out"):
        assert not re.search(r"\b" + gone + r"\b", code), gone
    for need in ("cudaLaunchAttributeProgrammaticStreamSerialization", "cudaLaunchKernelEx",
                 "cudaStreamBeginCapture", "cudaGraphInstantiate", "cudaGraphLaunch",
                 "griddepcontrol.launch_dependents", "griddepcontrol.wait",
                 "cudaSharedmemCarveoutMaxShared"):
        assert need in code, need
    assert re.findall(r"launch_phase\((\w+),", code) == ["streamed_in", "streamed_out"]
    written = ("__ldcg(", "stage_taps(", "stage_h(", "stage_rows(", "p.tbase", "p.h[",
               "p.skip[", "p.ring[", "p.gb[", "p.hb[", "p.condb[")
    for name in ("streamed_in", "streamed_out"):
        body = _kernel_body(code, name)
        assert body.index("pdl_trigger();") < body.index("pdl_wait();")
        work = body[body.index("if (!kLayerWork)"):]
        work = work[work.index("}") + 1:]  # past the empty variant's own wait
        before, after = work.split("pdl_wait();")
        assert "streamed_weights(" in before and "__syncthreads();" in before
        for w in written:
            assert w not in before, f"{name} touches {w} before griddepcontrol.wait"
        assert "__ldcg(p.tbase)" in after
        if name == "streamed_in":
            assert "__ldg(p.b" in before  # the gate's biases: read-only inputs
    helper = code[code.index("void streamed_weights("):]
    assert "bulk_load(" in helper[:helper.index("\n}")]


def test_cluster_plan():
    """P1's plan: a cluster of 8 CTAs a batch row, 64 channels and 64 w
    values a thread (in registers) each, the ring slice of 504 slots x 64
    channels, u's two buffers and the partial sums in shared memory."""
    plan = bench_taps.cluster_plan(512, 504)
    assert (plan["cluster"], plan["cols"], plan["threads"], plan["w_regs"]) == (8, 64, 512, 64)
    assert plan["ring_bytes"] == 504 * 64 * 4
    assert plan["smem_bytes"] == (504 * 64 + 2 * 512 + 2 * 8 * 64) * 4 + 16
    assert bench_taps.cluster_plan(512, 504, "compute")["ring_bytes"] == 0
    dil = _common.geometry(bench_taps.LAYERS)[0]
    assert bench_taps.ring_slots(dil) == 504


@pytest.mark.parametrize("r,slots,why", [(256, 504, "R = 8 x 64"), (1024, 504, "R = 8 x 64"),
                                         (512, 900, "over the")], ids=["narrow", "wide", "ring"])
def test_cluster_plan_refuses(r, slots, why):
    with pytest.raises(ValueError, match=why):
        bench_taps.cluster_plan(r, slots)
    if r == 512:  # what a mode without a ring still takes
        assert bench_taps.cluster_plan(r, slots, "compute")["ring_bytes"] == 0


def test_cluster_kernel_source():
    """P1 is one cluster launch with constants as the wrapper plans them,
    its exchange a st.async onto the peers' mbarriers: no grid barrier, no
    cooperative launch."""
    found = _cu_constants("bench_taps.cu")
    for cu, py in (("kCluster", "CLUSTER"), ("kThreads", "THREADS"), ("kCols", "COLS"),
                   ("kMaxSmem", "MAX_SMEM")):
        assert int(found[cu]) == getattr(bench_taps, py), cu
    code = _code("bench_taps.cu")
    assert "cudaLaunchAttributeClusterDimension" in code and "cudaLaunchKernelEx" in code
    assert "st.async.shared::cluster.mbarrier::complete_tx::bytes" in code
    for gone in ("grid_group", "this_grid", "cudaLaunchCooperativeKernel", "grid.sync"):
        assert gone not in code, gone


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
    lambda: bench_taps.device_plan(512, 504),
    lambda: bench_body.device_plan(8, 24, 512, 512, 256, 80),
    lambda: bench_body.streamed_device_plan(8, 24, 512, 512, 256, 80),
    lambda: bench_sync.main([]),
], ids=["taps-make", "taps-bench", "resident", "streamed", "body2-make", "body2-bench",
        "taps-main", "body-main", "body2-main", "ablate-main", "taps-plan", "body-plan",
        "streamed-plan", "sync-main"])
def test_cuda_without_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()
