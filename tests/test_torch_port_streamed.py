"""Port parity of dvc_tpu's streamed WaveNet kernel (K3, ``_streamed_call``)
and its entry point ``pallas_generate`` at the TINY config of
tests/test_torch_port_wavenet.py: the int8 quantizer and pack bit for bit,
the plain int8 sampler against the interpret-mode quantized kernel, and
``generate`` against the streamed kernel's other grid shapes (weights
streamed, fused matmuls, two layers per block), all under the doctored
deterministic head."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvc_tpu.kernels import wavenet_step as jstep
from dvc_tpu_torch.kernels import generate, pack_wavenet_params
from dvc_tpu_torch.kernels import wavenet_step as step
from test_torch_port_wavenet import JTINY, TINY, TOL, _jax_params, _moving, _port

R, C, S = TINY.residual_channels, TINY.cin_channels, TINY.skip_out_channels
G2 = TINY.gate_channels // 2


@pytest.fixture(scope="module")
def det():
    params = _moving(_jax_params(0))
    return params, _port(params)


def _frames(seed=0):
    return np.random.RandomState(seed).rand(2, 3, C).astype(np.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _zero_col(w):
    w = w.copy()
    w[..., 1] = 0.0  # an all-zero output column: the 1e-12 scale floor
    return w


@pytest.mark.parametrize("w", [
    _rand((16, 8), 0),
    _zero_col(_rand((5, 12), 1, 1e3)),      # large values, one zero column
    _rand((3, 7, 9), 2, 1e-6),              # three axes, tiny values
    np.linspace(-127.5, 127.5, 64, dtype=np.float32).reshape(16, 4),  # codes at +-127
], ids=["plain", "zero-column", "3d-tiny", "clip"])
def test_quantize_int8_bit_equal(w):
    q, s = step._quantize_int8(w)
    q_j, s_j = jstep._quantize_int8(w)
    assert q.dtype == q_j.dtype == np.int8 and s.dtype == s_j.dtype == np.float32
    np.testing.assert_array_equal(q, q_j)
    np.testing.assert_array_equal(s, s_j)
    assert np.abs(q).max() == 127


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_int8_pack_bit_equal(det, wd):
    """Codes and scales segment by segment against dvc_tpu's quantize=True
    pack; every padding code is zero; w_f1 stays in the weight dtype."""
    params, m = det
    want = jstep.pack_wavenet_params(params, JTINY, getattr(jnp, wd), quantize=True)
    got = step.pack_wavenet_params(m, getattr(torch, wd), "cpu", quantize=True)
    rs = step._tap_stride(TINY, True)
    w_in, w_so = got["w_in"].numpy(), got["w_so"].numpy()
    assert w_in.dtype == w_so.dtype == np.int8
    assert rs % 16 == 0 and w_in.shape[2] % 16 == 0 and w_so.shape[2] % 16 == 0
    s_in, s_so = got["s_in"].numpy(), got["s_so"].numpy()
    for tap in range(3):
        seg = w_in[:, :, tap * rs:(tap + 1) * rs]
        np.testing.assert_array_equal(seg[..., :R],
                                      np.asarray(want["w_dil"][:, tap]).transpose(0, 2, 1))
        assert not seg[..., R:].any()
        np.testing.assert_array_equal(s_in[:, tap], np.asarray(want["s_dil"][:, tap]))
    np.testing.assert_array_equal(w_in[:, :, 3 * rs:3 * rs + C],
                                  np.asarray(want["w_c"]).transpose(0, 2, 1))
    assert not w_in[:, :, 3 * rs + C:].any()
    np.testing.assert_array_equal(s_in[:, 3], np.asarray(want["s_c"]))
    np.testing.assert_array_equal(w_so[:, :S, :G2],
                                  np.asarray(want["w_skip"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(w_so[:, S:, :G2],
                                  np.asarray(want["w_out"]).transpose(0, 2, 1))
    assert not w_so[:, :, G2:].any()
    np.testing.assert_array_equal(s_so[:, :S], np.asarray(want["s_skip"]))
    np.testing.assert_array_equal(s_so[:, S:], np.asarray(want["s_out"]))
    assert got["w_f1"].dtype == getattr(torch, wd)
    np.testing.assert_array_equal(got["w_f1"].float().numpy().T,
                                  np.asarray(want["w_f1"].astype(jnp.float32)))
    assert step.pack_wavenet_params_cached(m, torch.float32, "cpu", quantize=True)["w_in"] \
        .dtype == torch.int8
    assert step.pack_wavenet_params_cached(m, torch.float32, "cpu")["w_in"].dtype \
        == torch.float32


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_plain_int8_matches_pallas_quantized(det, wd):
    """The plain int8 sampler (through generate on the CPU) against the
    quantized streamed kernel in interpret mode: atol 2e-4."""
    params, m = det
    c = _frames()
    want = np.asarray(jstep.pallas_generate({"params": params}, jnp.asarray(c), seed=5,
                                            cfg=JTINY, interpret=True,
                                            weight_dtype=getattr(jnp, wd),
                                            deterministic=True, quantize_int8=True))
    got = generate(m, c, 5, weight_dtype=getattr(torch, wd), deterministic=True,
                   quantize_int8=True, device="cpu").numpy()
    assert got.shape == want.shape == (2, 12)
    assert want.std() > 1e-2 and np.abs(want).max() < 1.0  # moves, off the clip
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [dict(resident=False), dict(fuse_matmuls=True),
                                   dict(layers_per_block=2)],
                         ids=["streamed", "fused", "two-layers-per-block"])
def test_generate_matches_streamed_grid_shapes(det, shape):
    """generate with float32 weights on the CPU against pallas_generate's
    streamed grid shapes, which compute the resident kernel's function."""
    params, m = det
    c = _frames(1)
    want = np.asarray(jstep.pallas_generate({"params": params}, jnp.asarray(c), seed=9,
                                            cfg=JTINY, interpret=True,
                                            weight_dtype=jnp.float32,
                                            deterministic=True, **shape))
    got = generate(m, torch.from_numpy(c), 9, weight_dtype=torch.float32,
                   deterministic=True, device="cpu").numpy()
    assert got.shape == want.shape == (2, 12)
    assert want.std() > 1e-2 and np.abs(want).max() < 1.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_generate_without_card_raises(det, monkeypatch):
    _, m = det
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        generate(m, _frames())  # cuda is the default
    with pytest.raises(RuntimeError, match="no CUDA card"):
        generate(m, _frames(), quantize_int8=True, device="cuda")


def test_generate_int8_stochastic_on_cpu():
    """Undoctored head, int8 weights, sampling: finite, in [-1, 1],
    repeatable per seed and different across seeds."""
    m = _port(_jax_params(3, doctor=False))
    c = _frames(2)
    s1, s1b, s2 = (generate(m, c, s, quantize_int8=True, device="cpu").numpy()
                   for s in (1, 1, 2))
    assert s1.shape == (2, 12)
    assert np.isfinite(s1).all() and np.abs(s1).max() <= 1.0
    np.testing.assert_array_equal(s1, s1b)
    assert not np.array_equal(s1, s2)
    assert pack_wavenet_params(m, torch.bfloat16, "cpu", quantize=True)["w_f1"].dtype \
        == torch.bfloat16
