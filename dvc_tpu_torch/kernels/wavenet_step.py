"""WaveNet autoregressive MoL generation: the CUDA kernel's wrapper, its
packed weights and its plain PyTorch version.

Replaces dvc_tpu/kernels/wavenet_step.py's resident Pallas kernel (K1+K2:
``_resident_call`` :387-429 with ``_make_kernel_resident`` and
``_mol_sample``).  The kernel is csrc/wavenet_step.cu (design, bound and
races are described there); this module holds

  * ``pack_wavenet_params`` — the WaveNet's weights stacked per layer,
    output-major, in the weight dtype (float32 biases, w_first and final2);
  * ``pack_wavenet_params_cached`` — a memo keyed like dvc_tpu's
    ``pack_wavenet_params_cached`` (:121-142), so the ~49 MB pack and upload
    happen once per weight set, never once per request;
  * ``wavenet_generate`` — the wrapper: a CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version;
  * ``wavenet_generate_plain`` — the same arithmetic in PyTorch, cast for
    cast, ring for ring;
  * ``mol_sample`` — a launch of the kernel's MoL sampler alone over given
    MoL parameters (the check of K2 against ``sample_from_mol``).

Each wrapper counts its kernel launches in a plain integer attribute
(``wavenet_generate.launches``, ``mol_sample.launches``).

The TPU path's ``samples_per_step`` and ``single_draw`` were tuning knobs
for the TPU grid and its PRNG with the contract "same trajectory as the
default"; this kernel does not take them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.models.wavenet import WaveNet, sample_from_mol

SQRT_HALF = math.sqrt(0.5)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PACK_CACHE: dict = {}


def pack_wavenet_params(model: WaveNet, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cuda") -> dict[str, Any]:
    """WaveNet -> layer-stacked, output-major weights for the kernel:

      w_in  (L, G, KIp)     [tap x_{t-2d} | tap x_{t-d} | tap h | cond | 0],
                            dtype, rows zero-padded from 3R + C to KIp, a
                            multiple of 8, so they are whole 16-byte vectors
      b_in  (L, G)          float32
      w_so  (L, S + R, G/2) [skip rows | out rows], dtype
      b_so  (L, S + R)      float32
      w_first, b_first (R,), w_f1 (S, S) dtype, b_f1 (S,),
      w_f2 (K, S), b_f2 (K,) float32
    plus the ring geometry (dilations, offsets, slots) and the config."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"weight dtype must be float32 or bfloat16, got {dtype}")
    cfg = model.cfg
    dev = torch.device(device)
    with torch.no_grad():
        w_in, b_in, w_so, b_so = [], [], [], []
        for layer in model.conv_layers:
            w = layer.conv.weight.float()                   # (G, R, 3)
            w_in.append(torch.cat([w.permute(0, 2, 1).reshape(w.shape[0], -1),
                                   layer.conv1x1c.weight[:, :, 0].float()], 1))
            b_in.append(layer.conv.bias.float())
            w_so.append(torch.cat([layer.conv1x1_skip.weight[:, :, 0],
                                   layer.conv1x1_out.weight[:, :, 0]], 0).float())
            b_so.append(torch.cat([layer.conv1x1_skip.bias,
                                   layer.conv1x1_out.bias]).float())
        ki = 3 * cfg.residual_channels + cfg.cin_channels
        w_in = F.pad(torch.stack(w_in), (0, -ki % 8))
        f1, f2 = model.last_conv_layers[1], model.last_conv_layers[3]

        def put(t, dt=torch.float32):
            return t.detach().to(device=dev, dtype=dt).contiguous()

        dil = np.array([cfg.dilation(i) for i in range(cfg.layers)], np.int32)
        return {
            "cfg": cfg,
            "w_in": put(w_in, dtype),
            "b_in": put(torch.stack(b_in)),
            "w_so": put(torch.stack(w_so), dtype),
            "b_so": put(torch.stack(b_so)),
            "w_first": put(model.first_conv.weight[:, 0, 0]),
            "b_first": put(model.first_conv.bias),
            "w_f1": put(f1.weight[:, :, 0], dtype),
            "b_f1": put(f1.bias),
            "w_f2": put(f2.weight[:, :, 0]),
            "b_f2": put(f2.bias),
            "dil": dil,
            "offs": np.concatenate([[0], np.cumsum(2 * dil)[:-1]]).astype(np.int32),
            "slots": int((2 * dil).sum()),
        }


def pack_wavenet_params_cached(model: WaveNet, dtype: torch.dtype = torch.bfloat16,
                               device: str | torch.device = "cuda") -> dict[str, Any]:
    """Memoized pack_wavenet_params, keyed by the model's identity, the
    dtype, the device and the config by value.  Weights changed in place
    after packing are not seen: pack a new model instead."""
    key = (id(model), str(dtype), str(torch.device(device)), model.cfg)
    hit = _PACK_CACHE.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]
    packed = pack_wavenet_params(model, dtype, device)
    if len(_PACK_CACHE) > 4:
        _PACK_CACHE.clear()
    _PACK_CACHE[key] = (model, packed)  # strong ref keeps id() stable
    return packed


def _dims(packed: dict) -> tuple[int, ...]:
    """(L, R, G, S, C, K) of the packed WaveNet."""
    cfg: VocoderConfig = packed["cfg"]
    return (cfg.layers, cfg.residual_channels, cfg.gate_channels,
            cfg.skip_out_channels, cfg.cin_channels, cfg.out_channels)


# --- plain PyTorch version ---------------------------------------------------

def _mol_mean(y_hat: torch.Tensor) -> torch.Tensor:
    """Deterministic MoL: the argmax mixture's mean, clipped to [-1, 1]."""
    nr_mix = y_hat.shape[-1] // 3
    sel = torch.argmax(y_hat[..., :nr_mix], dim=-1, keepdim=True)
    return torch.clamp(torch.gather(y_hat[..., nr_mix:2 * nr_mix], -1, sel)[..., 0],
                       -1.0, 1.0)


@torch.no_grad()
def wavenet_generate_plain(packed: dict, cond: torch.Tensor, seed: int = 0,
                           deterministic: bool = False) -> torch.Tensor:
    """The kernel's function in PyTorch: cond (B, T, C) float32 -> (B, T).

    Same casts as the kernel (activations to the weight dtype before each
    product, float32 accumulation, h stored in the ring in the weight dtype)
    and the same mod-2d ring.  Stochastic draws come from a torch.Generator
    seeded with ``seed``, not from the kernel's Philox stream."""
    cfg: VocoderConfig = packed["cfg"]
    L, R, G, S, C, K = _dims(packed)
    G2 = G // 2
    b, t_total, _ = cond.shape
    dev = cond.device
    wdt = packed["w_in"].dtype
    w_in = packed["w_in"][:, :, :3 * R + C].float()
    w_so = packed["w_so"].float()
    w_f1 = packed["w_f1"].float()
    b_in, b_so = packed["b_in"], packed["b_so"]
    w_first, b_first = packed["w_first"], packed["b_first"]
    scale = SQRT_HALF if cfg.legacy else 1.0
    dil, offs = packed["dil"].tolist(), packed["offs"].tolist()
    gen = None if deterministic else torch.Generator(device=dev).manual_seed(seed)

    ring = torch.zeros(packed["slots"], b, R, dtype=wdt, device=dev)
    x = torch.zeros(b, device=dev)
    out = torch.empty(b, t_total, device=dev)
    for t in range(t_total):
        h = x[:, None] * w_first + b_first
        c_t = cond[:, t].to(wdt)
        skip = None
        for li in range(L):
            d, off = dil[li], offs[li]
            wp = t % (2 * d)
            tap_2d, tap_d = off + wp, off + (wp + d) % (2 * d)
            xin = torch.cat([ring[tap_2d], ring[tap_d], h.to(wdt), c_t], -1).float()
            pre = xin @ w_in[li].T + b_in[li]
            gated = torch.tanh(pre[:, :G2]) * torch.sigmoid(pre[:, G2:])
            so = gated.to(wdt).float() @ w_so[li].T + b_so[li]
            ring[tap_2d] = h.to(wdt)
            h = (so[:, S:] + h) * SQRT_HALF
            skip = so[:, :S] if skip is None else (skip + so[:, :S]) * scale
        o = F.relu(F.relu(skip).to(wdt).float() @ w_f1.T + packed["b_f1"])
        y_hat = o @ packed["w_f2"].T + packed["b_f2"]
        x = _mol_mean(y_hat) if deterministic else \
            sample_from_mol(y_hat, gen, cfg.log_scale_min)
        out[:, t] = x
    return out


# --- the kernel's wrappers ---------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("wavenet_step")
    if not getattr(lib, "_dvc_typed", False):
        lib.dvc_wavenet_generate.argtypes = (
            [_I] * 10 + [_VP, _I, ctypes.c_float, ctypes.c_ulonglong, _I] + [_VP] * 18)
        lib.dvc_wavenet_generate.restype = _I
        lib.dvc_mol_sample.argtypes = [_VP, ctypes.c_longlong, _I, _I,
                                       ctypes.c_ulonglong, _I, ctypes.c_float,
                                       _VP, _VP]
        lib.dvc_mol_sample.restype = _I
        lib.dvc_error_string.argtypes = [_I]
        lib.dvc_error_string.restype = ctypes.c_char_p
        lib._dvc_typed = True
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.dvc_error_string(err).decode()})")


def _seed64(seed: int) -> int:
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def wavenet_generate(packed: dict, cond: torch.Tensor, seed: int = 0,
                     deterministic: bool = False) -> torch.Tensor:
    """Autoregressive MoL generation: cond (B, T, C) float32 upsampled
    conditioning -> (B, T) waveform in [-1, 1].

    On a CUDA tensor this launches the hand-written kernel (the whole batch
    in one call) or raises; on a CPU tensor it runs wavenet_generate_plain.
    deterministic=True takes the argmax mixture's mean instead of sampling."""
    if cond.device.type == "cpu":
        return wavenet_generate_plain(packed, cond, seed, deterministic)
    if cond.device.type != "cuda":
        raise ValueError(f"unsupported device {cond.device}")
    L, R, G, S, C, K = _dims(packed)
    if cond.dim() != 3 or cond.shape[2] != C:
        raise ValueError(f"cond must be (B, T, {C}), got {tuple(cond.shape)}")
    if cond.dtype != torch.float32 or not cond.is_contiguous():
        raise ValueError("cond must be a contiguous float32 tensor")
    wdt = packed["w_in"].dtype
    tensors = [packed[k] for k in ("w_in", "b_in", "w_so", "b_so", "w_first",
                                   "b_first", "w_f1", "b_f1", "w_f2", "b_f2")]
    if any(p.device != cond.device or not p.is_contiguous() or p.data_ptr() % 16
           for p in tensors):
        raise ValueError("packed weights must be contiguous, 16-byte aligned and "
                         f"on {cond.device}; pack them for that device")
    if G % 16 or S % 8:
        raise ValueError(f"the kernel needs gate channels % 16 == 0 and skip "
                         f"channels % 8 == 0, got {G} and {S}")
    b, t_total, _ = cond.shape
    dev = cond.device
    out = torch.empty(b, t_total, device=dev)
    ring = torch.empty(packed["slots"], b, R, dtype=wdt, device=dev)
    h = torch.empty(2, b, R, device=dev)
    skip = torch.empty(b, S, device=dev)
    gated = torch.empty(b, G // 2, device=dev)
    fin = torch.empty(b, S, device=dev)
    dil = np.ascontiguousarray(packed["dil"], np.int32)
    cfg: VocoderConfig = packed["cfg"]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dvc_wavenet_generate(
            _DTYPE_CODE[wdt], b, t_total, L, R, G, S, C, packed["w_in"].shape[2], K,
            dil.ctypes.data, int(cfg.legacy), cfg.log_scale_min, _seed64(seed),
            int(deterministic), *(p.data_ptr() for p in tensors), cond.data_ptr(),
            ring.data_ptr(), h.data_ptr(), skip.data_ptr(), gated.data_ptr(),
            fin.data_ptr(), out.data_ptr(), stream)
    _check(lib, err, "wavenet_generate")
    wavenet_generate.launches += 1
    return out


wavenet_generate.launches = 0


def mol_sample(y_hat: torch.Tensor, seed: int = 0, deterministic: bool = False,
               log_scale_min: float = VocoderConfig.log_scale_min) -> torch.Tensor:
    """One MoL draw per row of y_hat (N, 3K) float32 with unit stride on the
    last axis (a row stride of 0, e.g. ``y.expand(N, -1)``, repeats one row).

    On a CUDA tensor this launches the kernel's sampler alone (row n draws
    the Philox numbers of sample 0, batch row n); on a CPU tensor it runs
    sample_from_mol (or the argmax mean when deterministic)."""
    if y_hat.dim() != 2 or y_hat.shape[1] % 3 != 0:
        raise ValueError(f"y_hat must be (N, 3K), got {tuple(y_hat.shape)}")
    if y_hat.device.type == "cpu":
        if deterministic:
            return _mol_mean(y_hat)
        gen = torch.Generator().manual_seed(seed)
        return sample_from_mol(y_hat, gen, log_scale_min)
    if y_hat.device.type != "cuda":
        raise ValueError(f"unsupported device {y_hat.device}")
    if y_hat.dtype != torch.float32 or y_hat.stride(1) != 1:
        raise ValueError("y_hat must be float32 with a unit last-axis stride")
    n, k = y_hat.shape
    out = torch.empty(n, device=y_hat.device)
    lib = _lib()
    with torch.cuda.device(y_hat.device):
        stream = torch.cuda.current_stream(y_hat.device).cuda_stream
        err = lib.dvc_mol_sample(y_hat.data_ptr(), y_hat.stride(0), n, k,
                                 _seed64(seed), int(deterministic),
                                 log_scale_min, out.data_ptr(), stream)
    _check(lib, err, "mol_sample")
    mol_sample.launches += 1
    return out


mol_sample.launches = 0
