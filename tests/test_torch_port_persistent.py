"""The persistent WaveNet sampler's block plan (dvc_tpu_torch.kernels.
wavenet_step.block_plan) at the TINY, NARROW and full widths, with no card:
every gate pair, skip/out row and final1 column has exactly one block; what
stays resident in a block's 232,448 bytes of shared memory, per dtype; plans
that cannot fit raise; the kernel source makes one cooperative launch and
keeps no per-layer kernels; and the plain sampler on a packed TINY model
still matches dvc_tpu's interpret-mode kernel."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.kernels import wavenet_step as jstep
from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.kernels import wavenet_step as step
from dvc_tpu_torch.models.wavenet import WaveNet
from test_torch_port_wavenet import JTINY, TINY, TOL, _jax_params, _moves, _moving, _port

H100_SMS = 132
SMEM = 232_448   # bytes of shared memory an H100 block may use
NARROW = VocoderConfig(layers=8, stacks=2, residual_channels=64, gate_channels=64,
                       skip_out_channels=32)  # chip_smoke.NARROW
CONFIGS = {"tiny": TINY, "narrow": NARROW, "full": VocoderConfig()}
PACKS = {"float32": (torch.float32, False), "bfloat16": (torch.bfloat16, False),
         "int8": (torch.bfloat16, True), "int8-f32-final1": (torch.float32, True)}
SRC = Path(step.__file__).with_name("csrc") / "wavenet_step.cu"


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    return {name: WaveNet(cfg).eval() for name, cfg in CONFIGS.items()}


_packs: dict = {}


def _pack(models, cfg_name, pack):
    key = (cfg_name, pack)
    if key not in _packs:
        dtype, quantize = PACKS[pack]
        _packs[key] = step.pack_wavenet_params(models[cfg_name], dtype, "cpu", quantize)
    return _packs[key]


def _ranges(n, per, blocks):
    """The kernel's own ownership rule: block k owns [k * per, k * per + m)
    with m = max(0, min(per, n - k * per))."""
    return [range(k * per, k * per + max(0, min(per, n - k * per))) for k in range(blocks)]


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_plan_owns_every_row_once(models, cfg_name):
    cfg = CONFIGS[cfg_name]
    G2, S, R = cfg.gate_channels // 2, cfg.skip_out_channels, cfg.residual_channels
    for pack in PACKS:
        packed = _pack(models, cfg_name, pack)
        for batch in (1, 3, 9):
            plan = step.block_plan(packed, batch, H100_SMS)
            assert plan["blocks"] <= H100_SMS and plan["pairs"] in (1, 2, 4)
            for key, n in (("pairs", G2), ("rows", S + R), ("cols", S)):
                runs = _ranges(n, plan[key], plan["blocks"])
                got = sorted(i for r in runs for i in r)
                assert got == list(range(n)), (pack, batch, key)  # each once
            # no block idles in phase `in`
            assert all(len(r) for r in _ranges(G2, plan["pairs"], plan["blocks"]))
    if cfg_name == "full":
        plan = step.block_plan(_pack(models, "full", "int8"), 3, H100_SMS)
        assert (plan["blocks"], plan["pairs"], plan["rows"], plan["cols"]) == (128, 2, 6, 2)


@pytest.mark.parametrize("pack", ["int8", "int8-f32-final1"])
def test_int8_full_width_fully_resident(models, pack):
    """The main path's B = 3: every layer of the int8 pack stays in shared
    memory for all T steps, 24 x (4 x 1616 + 6 x 256) = 192,000 B of codes a
    block, within 232,448 B with the kernel's static arrays set aside."""
    packed = _pack(models, "full", pack)
    plan = step.block_plan(packed, 3, H100_SMS)
    assert plan["resident_layers"] == 24 and plan["streamed_bytes_per_step"] == 0
    assert plan["layer_bytes"] == 4 * 1616 + 6 * 256 == 8000
    assert 192_000 < plan["resident_bytes"] < plan["smem_bytes"] <= SMEM - step.STATIC_SMEM
    assert plan["tile"] == 3


@pytest.mark.parametrize("pack,layer_bytes,resident", [("bfloat16", 16_000, 11),
                                                       ("float32", 32_000, 4)])
def test_partial_residency(models, pack, layer_bytes, resident):
    """bf16 and float32 do not fit whole: the leading layers stay, the rest
    stream through a double buffer, and the plan says how many of each."""
    packed = _pack(models, "full", pack)
    plan = step.block_plan(packed, 3, H100_SMS)
    assert plan["layer_bytes"] == layer_bytes
    assert plan["resident_layers"] == resident
    assert plan["streamed_bytes_per_step"] == (24 - resident) * layer_bytes * 128
    assert plan["smem_bytes"] <= SMEM - step.STATIC_SMEM
    # one more resident layer would not fit beside the double buffer
    assert plan["smem_bytes"] + layer_bytes > SMEM - step.STATIC_SMEM


def test_row_tile_choice(models):
    """Residency first, then the largest tile: int8 at B = 8 keeps all 24
    layers with a tile of 8 (bf16 activations staged: 8 x 1616 x 2 B);
    float32 at B = 9 crosses its tile of 8."""
    plan = step.block_plan(_pack(models, "full", "int8"), 8, H100_SMS)
    assert (plan["tile"], plan["resident_layers"]) == (8, 24)
    plan = step.block_plan(_pack(models, "full", "float32"), 9, H100_SMS)
    assert plan["tile"] == 8 < 9
    tiny = step.block_plan(_pack(models, "tiny", "float32"), 20, H100_SMS)
    assert tiny["tile"] == step.MAX_TILE and tiny["resident_layers"] == TINY.layers


def test_plan_that_cannot_fit_raises(models):
    packed = _pack(models, "full", "int8")
    with pytest.raises(ValueError, match="does not fit"):
        step.block_plan(packed, 20_000, H100_SMS)  # per-row state alone exceeds the budget
    with pytest.raises(ValueError, match="gate pairs"):
        step.block_plan(packed, 3, 16)  # 256 pairs on 16 SMs: 16 a block
    with pytest.raises(ValueError):
        step.block_plan(packed, 0, H100_SMS)


def test_kernel_source_is_one_persistent_launch():
    """One cooperative launch per wavenet_generate call, no per-layer
    kernels and no host loop over samples: the only <<<>>> launch left is
    the MoL sampler's own check kernel."""
    src = SRC.read_text()
    assert src.count("cudaLaunchCooperativeKernel(") == 1
    assert re.findall(r"(\w+)<<<", src) == ["mol_sample_kernel"]
    for gone in ("layer_in_kernel", "layer_out_kernel", "final1_kernel", "head_kernel",
                 "init_h_kernel"):
        assert gone not in src
    assert src.count("grid.sync()") == 4  # ring zeroed; (a), (b) a layer; after final1


@pytest.mark.parametrize("py_name,cu_name", [("MAX_SMEM", "kMaxSmem"),
                                             ("STATIC_SMEM", "kStaticReserve"),
                                             ("MAX_TILE", "kMaxTile"), ("SEGS", "kSegs")])
def test_plan_constants_match_kernel_source(py_name, cu_name):
    """block_plan and the kernel's layout_of each reckon the shared-memory
    layout; the kernel refuses a plan whose bytes differ from its own, which
    only a card would show.  Their constants must be the same numbers."""
    src = SRC.read_text()
    found = re.findall(rf"constexpr int {cu_name} = (\d+);", src)
    assert found == [str(getattr(step, py_name))], (py_name, found)


def test_plan_pairs_match_kernel_source():
    """The kernel takes 1, 2 or 4 gate pairs a block (its 8 warps split
    evenly over them); block_plan picks a power of two up to MAX_PAIRS."""
    src = SRC.read_text()
    assert "(pairs != 1 && pairs != 2 && pairs != 4)" in src
    assert step.MAX_PAIRS == 4


def test_checked_launch_refuses_cpu(models):
    """The check launch has no plain fallback: a CPU tensor raises."""
    packed = _pack(models, "tiny", "float32")
    cond = torch.zeros(1, 4, TINY.cin_channels)
    with pytest.raises(ValueError, match="unsupported device"):
        step.wavenet_generate_checked(packed, cond)


@pytest.fixture(scope="module")
def open_loop_tiny():
    """The TINY model with the moving head and first_conv zeroed (no sample
    fed back), and its upsampled conditioning, B = 2, 40 steps."""
    m = _port(_moving(_jax_params(0)))
    with torch.no_grad():
        m.first_conv.weight.zero_()
        c = np.random.RandomState(6).rand(2, 10, TINY.cin_channels).astype(np.float32)
        return m, m.upsample(torch.from_numpy(c)).contiguous()


@pytest.mark.parametrize("pack", list(PACKS))
def test_open_loop_plain_matches_step_loop(open_loop_tiny, pack):
    """wavenet_open_loop_plain, which chip_smoke.py holds the kernel to at
    the main path's shape with the feedback cut, computes what the step
    loop computes for such a pack: atol 1e-6 (the products' row counts
    differ, nothing else)."""
    m, cond = open_loop_tiny
    dtype, quantize = PACKS[pack]
    packed = step.pack_wavenet_params(m, dtype, "cpu", quantize)
    want = step.wavenet_generate_plain(packed, cond, 0, deterministic=True)
    got = step.wavenet_open_loop_plain(packed, cond)
    assert got.shape == want.shape == (2, 40)
    assert _moves(want.numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def feedback_tiny():
    """The TINY model with the moving head and its feedback kept, and its
    upsampled conditioning, B = 2, 40 steps."""
    m = _port(_moving(_jax_params(0)))
    c = np.random.RandomState(7).rand(2, 10, TINY.cin_channels).astype(np.float32)
    with torch.no_grad():
        return m, m.upsample(torch.from_numpy(c)).contiguous()


@pytest.mark.parametrize("pack", list(PACKS))
def test_open_loop_plain_teacher_forced_matches_step_loop(feedback_tiny, pack):
    """wavenet_open_loop_plain teacher-forced on the step loop's own samples,
    which chip_smoke.py holds the main path's bf16 kernel to over all its
    steps, returns the step loop's output (atol 1e-6, as above); forced on
    other samples it returns something else."""
    m, cond = feedback_tiny
    dtype, quantize = PACKS[pack]
    packed = step.pack_wavenet_params(m, dtype, "cpu", quantize)
    assert bool(packed["w_first"].any())
    want = step.wavenet_generate_plain(packed, cond, 0, deterministic=True)
    got = step.wavenet_open_loop_plain(packed, cond, feedback=want)
    assert got.shape == want.shape == (2, 40)
    assert _moves(want.numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    other = step.wavenet_open_loop_plain(packed, cond, feedback=want.flip(1))
    assert (other - want).abs().max().item() > 1e-3
    with pytest.raises(ValueError, match="feedback"):
        step.wavenet_open_loop_plain(packed, cond, feedback=want[:, :-1])


def test_open_loop_plain_refuses_feedback(models):
    packed = _pack(models, "tiny", "float32")
    with pytest.raises(ValueError, match="feedback"):
        step.wavenet_open_loop_plain(packed, torch.zeros(1, 4, TINY.cin_channels))


def test_plain_on_packed_tiny_matches_dvc_tpu():
    """wavenet_generate_plain on a packed TINY model against the interpret-
    mode Pallas kernel, float32 weights, atol 2e-4, as
    tests/test_torch_port_wavenet.py holds it, with a batch of 3."""
    params = _moving(_jax_params(0))
    m = _port(params)
    c = np.random.RandomState(5).rand(3, 3, TINY.cin_channels).astype(np.float32)
    want = np.asarray(jstep.pallas_generate({"params": params}, jnp.asarray(c), seed=1,
                                            cfg=JTINY, interpret=True,
                                            weight_dtype=jnp.float32, deterministic=True))
    packed = step.pack_wavenet_params(m, torch.float32, "cpu")
    with torch.no_grad():
        cond = m.upsample(torch.from_numpy(c)).contiguous()
    got = step.wavenet_generate_plain(packed, cond, 1, deterministic=True).numpy()
    assert got.shape == want.shape == (3, 12)
    assert _moves(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
