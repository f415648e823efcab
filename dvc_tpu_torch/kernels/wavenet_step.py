"""WaveNet autoregressive MoL generation: the CUDA kernel's wrapper, its
block plan, its packed weights, its plain PyTorch version and ``generate``,
the port of dvc_tpu's ``pallas_generate``.

Replaces dvc_tpu/kernels/wavenet_step.py's Pallas kernels: the resident one
(K1+K2: ``_resident_call`` :388-429 with ``_make_kernel_resident`` and
``_mol_sample``) and the streamed one (K3: ``_streamed_call`` :706-787 with
``_make_kernel``, whose int8 weight streaming is the int8 pack below).  The
kernel is csrc/wavenet_step.cu: one persistent cooperative launch per call,
each block's weight rows resident in shared memory (design, bound and races
are described there); this module holds

  * ``generate`` — mel frames -> waveform: upsample, pack (memoized) and
    ``wavenet_generate``, as ``pallas_generate`` (:612-702) does;
  * ``pack_wavenet_params`` — the WaveNet's weights stacked per layer,
    output-major, in the weight dtype or as int8 codes with float32 scales
    (float32 biases, w_first and final2);
  * ``pack_wavenet_params_cached`` — a memo keyed like dvc_tpu's
    ``pack_wavenet_params_cached`` (:124-142), so the ~49 MB pack and upload
    happen once per weight set, never once per request;
  * ``block_plan`` — which rows each block owns, which layers stay resident
    in its shared memory, the row tile and the shared-memory bytes: the
    kernel takes the plan and refuses one whose bytes are not its own;
  * ``wavenet_generate`` — the wrapper: a CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version;
  * ``wavenet_generate_plain`` — the same arithmetic in PyTorch, cast for
    cast, ring for ring;
  * ``wavenet_open_loop_plain`` — its deterministic function for a pack
    with the output feedback cut, over all steps at once (for checks at
    long T);
  * ``mol_sample`` — a launch of the kernel's MoL sampler alone over given
    MoL parameters (the check of K2 against ``sample_from_mol``).

Each wrapper counts its kernel launches in an attribute:
``mol_sample.launches`` is an integer, ``wavenet_generate.launches`` a
Counter keyed by the pack's layer weight dtype ("float32", "bfloat16",
"int8"), one entry per instantiation of the kernel.

The TPU path's ``samples_per_step`` and ``single_draw`` were tuning knobs
for the TPU grid and its PRNG with the contract "same trajectory as the
default"; this kernel does not take them.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.config import VocoderConfig
from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.models.wavenet import WaveNet, sample_from_mol
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32

SQRT_HALF = math.sqrt(0.5)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT8_VEC = 16  # int8 codes in one 16-byte vector
# the kernel's launch shape and the card's shared memory (csrc/wavenet_step.cu)
MAX_SMEM = 232_448   # bytes of shared memory a block may use on an H100
STATIC_SMEM = 1_024  # of which the plan sets aside for the kernel's static arrays
MAX_TILE = 8         # batch rows per pass through the weights
MAX_PAIRS = 4        # gate pairs a block: the 8 warps split evenly over its pairs
SEGS = 4             # int8 w_in scale segments

_PACK_CACHE: dict = {}


def _quantize_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization: w ~= q * scale with
    scale over all axes but the last (output-channel) axis.  A copy of
    dvc_tpu/kernels/wavenet_step.py:111-118, so codes and scales are
    bit-equal to the JAX pack's."""
    red = tuple(range(w.ndim - 1))
    scale = np.max(np.abs(w), axis=red, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=red).astype(np.float32)


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _tap_stride(cfg: VocoderConfig, quantized: bool) -> int:
    """Length of one tap segment of a w_in row: R, padded to whole 16-code
    vectors in an int8 pack."""
    return _ceil(cfg.residual_channels, _INT8_VEC) if quantized else cfg.residual_channels


def _quantize_layers(taps: np.ndarray, w_c: np.ndarray, w_so: np.ndarray):
    """int8 codes and scales of the layer weights, quantized per segment as
    dvc_tpu's pack_wavenet_params(quantize=True) does (:188-211) and laid
    out output-major; each w_in segment and each w_so row zero-padded to
    whole 16-code vectors.  taps (L, G, R, 3), w_c (L, G, C) and
    w_so (L, S + R, G/2) are float32 in the torch layout."""
    L, G, R, _ = taps.shape
    C, (rows, G2) = w_c.shape[2], w_so.shape[1:]
    Rs, Cp, G2p = _ceil(R, _INT8_VEC), _ceil(C, _INT8_VEC), _ceil(G2, _INT8_VEC)
    q_in = np.zeros((L, G, 3 * Rs + Cp), np.int8)
    s_in = np.empty((L, 4, G), np.float32)
    q_so = np.zeros((L, rows, G2p), np.int8)
    s_so = np.empty((L, rows), np.float32)
    for li in range(L):
        # the (in, out) layout dvc_tpu quantizes: one scale per output column
        for tap in range(3):
            q, s_in[li, tap] = _quantize_int8(taps[li, :, :, tap].T)
            q_in[li, :, tap * Rs:tap * Rs + R] = q.T
        q, s_in[li, 3] = _quantize_int8(w_c[li].T)
        q_in[li, :, 3 * Rs:3 * Rs + C] = q.T
        # skip and out columns have a scale each, so one call quantizes both
        q, s_so[li] = _quantize_int8(w_so[li].T)
        q_so[li, :, :G2] = q.T
    return q_in, s_in, q_so, s_so


def pack_wavenet_params(model: WaveNet, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cuda",
                        quantize: bool = False) -> dict[str, Any]:
    """WaveNet -> layer-stacked, output-major weights for the kernel:

      w_in  (L, G, KIp)     [tap x_{t-2d} | tap x_{t-d} | tap h | cond | 0],
                            dtype, rows zero-padded from 3R + C to KIp, a
                            multiple of 8, so they are whole 16-byte vectors
      b_in  (L, G)          float32
      w_so  (L, S + R, G/2) [skip rows | out rows], dtype
      b_so  (L, S + R)      float32
      w_first, b_first (R,), w_f1 (S, S) dtype, b_f1 (S,),
      w_f2 (K, S), b_f2 (K,) float32
    plus the ring geometry (dilations, offsets, slots) and the config.

    quantize=True stores w_in and w_so as int8 codes, as dvc_tpu's
    quantize=True pack does (:188-211): every segment of a w_in row starts
    on a 16-code vector (taps at multiples of Rs = R rounded up to 16, cond
    padded to a multiple of 16) and w_so rows are padded to G2p, a multiple
    of 16, all padding zero; with them
      s_in  (L, 4, G)       float32 scales of tap x_{t-2d}, tap x_{t-d},
                            tap h and cond per output column
      s_so  (L, S + R)      float32 scale per w_so row.
    w_f1 stays in ``dtype`` (:231)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight dtype must be float32 or bfloat16, got {dtype}")
    cfg = model.cfg
    L, R, C = cfg.layers, cfg.residual_channels, cfg.cin_channels
    dev = torch.device(device)

    def put(t, dt=torch.float32):
        return torch.as_tensor(t).detach().to(device=dev, dtype=dt).contiguous()

    with torch.no_grad():
        layers = model.conv_layers
        taps = torch.stack([la.conv.weight for la in layers]).float()      # (L, G, R, 3)
        w_c = torch.stack([la.conv1x1c.weight[:, :, 0] for la in layers]).float()
        w_so = torch.stack([torch.cat([la.conv1x1_skip.weight[:, :, 0],
                                       la.conv1x1_out.weight[:, :, 0]], 0)
                            for la in layers]).float()
        b_in = torch.stack([la.conv.bias for la in layers])
        b_so = torch.stack([torch.cat([la.conv1x1_skip.bias, la.conv1x1_out.bias])
                            for la in layers])
        if quantize:
            q_in, s_in, q_so, s_so = _quantize_layers(
                *(t.cpu().numpy() for t in (taps, w_c, w_so)))
            weights = {"w_in": put(q_in, torch.int8), "s_in": put(s_in),
                       "w_so": put(q_so, torch.int8), "s_so": put(s_so)}
        else:
            w_in = torch.cat([taps.permute(0, 1, 3, 2).reshape(L, taps.shape[1], 3 * R),
                              w_c], 2)
            weights = {"w_in": put(F.pad(w_in, (0, -(3 * R + C) % 8)), dtype),
                       "w_so": put(w_so, dtype)}
        f1, f2 = model.last_conv_layers[1], model.last_conv_layers[3]
        dil = np.array([cfg.dilation(i) for i in range(L)], np.int32)
        return {
            "cfg": cfg,
            **weights,
            "b_in": put(b_in),
            "b_so": put(b_so),
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
                               device: str | torch.device = "cuda",
                               quantize: bool = False) -> dict[str, Any]:
    """Memoized pack_wavenet_params, keyed by the model's identity, the
    dtype, the device, quantize and the config by value.  Weights changed in
    place after packing are not seen: pack a new model instead."""
    key = (id(model), str(dtype), str(torch.device(device)), quantize, model.cfg)
    hit = _PACK_CACHE.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]
    packed = pack_wavenet_params(model, dtype, device, quantize)
    if len(_PACK_CACHE) > 4:
        _PACK_CACHE.clear()
    _PACK_CACHE[key] = (model, packed)  # strong ref keeps id() stable
    return packed


def _dims(packed: dict) -> tuple[int, ...]:
    """(L, R, G, S, C, K) of the packed WaveNet."""
    cfg: VocoderConfig = packed["cfg"]
    return (cfg.layers, cfg.residual_channels, cfg.gate_channels,
            cfg.skip_out_channels, cfg.cin_channels, cfg.out_channels)


def _act_dtype(packed: dict) -> torch.dtype:
    """Activation and ring dtype: bf16 for an int8 pack (dvc_tpu :512,
    :677), else the weight dtype."""
    wdt = packed["w_in"].dtype
    return torch.bfloat16 if wdt == torch.int8 else wdt


def _r16(n: int) -> int:
    return _ceil(n, 16)


def block_plan(packed: dict, batch: int, sms: int) -> dict[str, Any]:
    """How the kernel splits the packed WaveNet over a card with ``sms``
    streaming multiprocessors for a batch of ``batch`` rows.

    Each block owns ``pairs`` consecutive gate-column pairs (j, j + G/2)
    (a power of two up to 4, the fewest that cover G/2 with at most ``sms``
    blocks), and ``rows`` consecutive skip/out rows and ``cols`` consecutive
    final1 columns, the fewest that cover S + R and S with ``blocks``
    blocks; block k owns pairs [k * pairs, (k + 1) * pairs), and so on.
    Its shared memory holds, in the kernel's order, ``resident_layers``
    layers of its rows (each ``layer_bytes``), a double buffer for the
    layers streamed through it (when not all are resident), the biases
    and int8 scales of every layer, its final1 columns, its skip and h
    rows over the batch, the batch's draws and a staging tile of ``tile``
    batch rows.  The
    plan keeps every layer resident with the largest tile that allows it,
    else the largest tile with as many resident layers as fit; it raises
    ValueError when nothing fits ``MAX_SMEM`` (less ``STATIC_SMEM``)."""
    L, R, G, S, C, K = _dims(packed)
    G2 = G // 2
    w_in, w_so, w_f1 = packed["w_in"], packed["w_so"], packed["w_f1"]
    kip, g2p = w_in.shape[2], w_so.shape[2]
    if batch < 1 or sms < 1:
        raise ValueError(f"batch and sms must be positive, got {batch} and {sms}")
    pairs = 1
    while pairs * sms < G2:
        pairs *= 2
    if pairs > MAX_PAIRS:
        raise ValueError(f"{G2} gate pairs need more than {MAX_PAIRS} a block on {sms} SMs")
    blocks = -(-G2 // pairs)
    rows, cols = -(-(S + R) // blocks), -(-S // blocks)
    layer_bytes = _r16((2 * pairs * kip + rows * g2p) * w_in.element_size())
    scales = 2 * pairs * SEGS + rows if w_in.dtype == torch.int8 else 0
    consts = _r16(L * (scales + 2 * pairs + rows) * 4)  # scales and biases of every layer
    f1 = _r16(cols * S * w_f1.element_size())
    fixed = consts + f1 + _r16(rows * batch * 4) + _r16(batch * 4)
    # a staging row in the type each phase's dots read; the head's fin | y in float32
    asz, fsz = _act_dtype(packed).itemsize, w_f1.element_size()
    width = max(kip * asz, g2p * asz, S * fsz, (S + K) * 4)
    budget = MAX_SMEM - STATIC_SMEM

    def total(tile, nres):
        return (nres * layer_bytes + (2 * layer_bytes if nres < L else 0) + fixed
                + _r16(tile * width))

    tiles = range(min(MAX_TILE, batch), 0, -1)
    choice = next(((tile, L) for tile in tiles if total(tile, L) <= budget), None)
    if choice is None:
        choice = next(((tile, min(L - 1, (budget - total(tile, 0)) // layer_bytes))
                       for tile in tiles if total(tile, 0) <= budget), None)
    if choice is None:
        raise ValueError(f"the block plan does not fit {budget} bytes of shared memory: "
                         f"{layer_bytes} B a layer, {fixed} B of biases, scales, final1 "
                         f"and per-row state for B={batch}")
    tile, nres = choice
    return {"blocks": blocks, "pairs": pairs, "rows": rows, "cols": cols, "tile": tile,
            "resident_layers": nres, "layer_bytes": layer_bytes,
            "resident_bytes": nres * layer_bytes + consts + f1,
            "streamed_bytes_per_step": (L - nres) * layer_bytes * blocks,
            "smem_bytes": total(tile, nres)}


# --- plain PyTorch version ---------------------------------------------------

def _mol_mean(y_hat: torch.Tensor) -> torch.Tensor:
    """Deterministic MoL: the argmax mixture's mean, clipped to [-1, 1]."""
    nr_mix = y_hat.shape[-1] // 3
    sel = torch.argmax(y_hat[..., :nr_mix], dim=-1, keepdim=True)
    return torch.clamp(torch.gather(y_hat[..., nr_mix:2 * nr_mix], -1, sel)[..., 0],
                       -1.0, 1.0)


def _plain_weights(packed: dict) -> dict[str, Any]:
    """The packed layer weights in float32 as the plain versions read them:
    int8 codes split per segment with their scales, else w_in and w_so."""
    L, R, G, S, C, K = _dims(packed)
    if packed["w_in"].dtype != torch.int8:
        return {"w_in": packed["w_in"][:, :, :3 * R + C].float(),
                "w_so": packed["w_so"].float()}
    rs = _tap_stride(packed["cfg"], True)
    w_in = packed["w_in"]
    return {"w_taps": (w_in[:, :, :3 * rs].reshape(L, G, 3, rs)[..., :R]
                       .permute(0, 2, 3, 1).float()),                    # (L, 3, R, G)
            "s_taps": packed["s_in"][:, :3, None, :],                    # (L, 3, 1, G)
            "w_c": w_in[:, :, 3 * rs:3 * rs + C].transpose(1, 2).float(),  # (L, C, G)
            "s_c": packed["s_in"][:, 3, None, :],                        # (L, 1, G)
            "w_so": packed["w_so"][:, :, :G // 2].float()}


@torch.no_grad()
def wavenet_generate_plain(packed: dict, cond: torch.Tensor, seed: int = 0,
                           deterministic: bool = False) -> torch.Tensor:
    """The kernel's function in PyTorch: cond (B, T, C) float32 -> (B, T).

    Same casts as the kernel (activations to the activation dtype before
    each product, float32 accumulation, h stored in the ring in the
    activation dtype, final1's input in w_f1's dtype) and the same mod-2d
    ring.  An int8 pack takes dvc_tpu's arithmetic (:512-519, :552-567):
    bf16 activations times the int8 codes summed in float32, then times the
    segment's scale, per segment.  Stochastic draws come from a
    torch.Generator seeded with ``seed``, not from the kernel's Philox
    stream."""
    cfg: VocoderConfig = packed["cfg"]
    L, R, G, S, C, K = _dims(packed)
    G2 = G // 2
    b, t_total, _ = cond.shape
    dev = cond.device
    quant = packed["w_in"].dtype == torch.int8
    adt = _act_dtype(packed)
    pw = _plain_weights(packed)
    w_so = pw["w_so"]
    if quant:
        w_taps, s_taps, w_c, s_c = pw["w_taps"], pw["s_taps"], pw["w_c"], pw["s_c"]
    else:
        w_in = pw["w_in"]
    w_f1 = packed["w_f1"].float()
    f1dt = packed["w_f1"].dtype
    b_in, b_so = packed["b_in"], packed["b_so"]
    w_first, b_first = packed["w_first"], packed["b_first"]
    scale = SQRT_HALF if cfg.legacy else 1.0
    dil, offs = packed["dil"].tolist(), packed["offs"].tolist()
    gen = None if deterministic else torch.Generator(device=dev).manual_seed(seed)

    ring = torch.zeros(packed["slots"], b, R, dtype=adt, device=dev)
    x = torch.zeros(b, device=dev)
    out = torch.empty(b, t_total, device=dev)
    for t in range(t_total):
        h = x[:, None] * w_first + b_first
        c_t = cond[:, t].to(adt)
        if quant:  # every layer's cond product at once: (L, B, G)
            pc = torch.matmul(c_t.float(), w_c) * s_c
        skip = None
        for li in range(L):
            d, off = dil[li], offs[li]
            wp = t % (2 * d)
            tap_2d, tap_d = off + wp, off + (wp + d) % (2 * d)
            hq = h.to(adt)
            if quant:
                x3 = torch.stack([ring[tap_2d], ring[tap_d], hq]).float()  # (3, B, R)
                pre = (torch.bmm(x3, w_taps[li]) * s_taps[li]).sum(0) + b_in[li] + pc[li]
            else:
                xin = torch.cat([ring[tap_2d], ring[tap_d], hq, c_t], -1).float()
                pre = xin @ w_in[li].T + b_in[li]
            gated = torch.tanh(pre[:, :G2]) * torch.sigmoid(pre[:, G2:])
            so = gated.to(adt).float() @ w_so[li].T
            so = torch.addcmul(b_so[li], so, packed["s_so"][li]) if quant else so + b_so[li]
            ring[tap_2d] = hq
            h = (so[:, S:] + h) * SQRT_HALF
            skip = so[:, :S] if skip is None else (skip + so[:, :S]) * scale
        o = F.relu(F.relu(skip).to(f1dt).float() @ w_f1.T + packed["b_f1"])
        y_hat = o @ packed["w_f2"].T + packed["b_f2"]
        x = _mol_mean(y_hat) if deterministic else \
            sample_from_mol(y_hat, gen, cfg.log_scale_min)
        out[:, t] = x
    return out


@torch.no_grad()
def wavenet_open_loop_plain(packed: dict, cond: torch.Tensor) -> torch.Tensor:
    """wavenet_generate_plain(packed, cond, deterministic=True) for a pack
    whose w_first is zero, so that no sample is fed back: every step's input
    h is b_first, and each layer runs over all B x T steps at once, its ring
    taps being its own input h shifted by d and 2d steps (zero before the
    first step).  The same casts and sums as the step loop; only the row
    count of each product differs.  A reference for checks at long T, where
    the step loop takes minutes."""
    if bool(packed["w_first"].any()):
        raise ValueError("the output feedback is not cut: w_first is not zero")
    cfg: VocoderConfig = packed["cfg"]
    L, R, G, S, C, K = _dims(packed)
    G2 = G // 2
    b, t_total, _ = cond.shape
    quant = packed["w_in"].dtype == torch.int8
    adt = _act_dtype(packed)
    pw = _plain_weights(packed)
    b_in, b_so = packed["b_in"], packed["b_so"]
    scale = SQRT_HALF if cfg.legacy else 1.0
    c = cond.to(adt)
    h = packed["b_first"].expand(b, t_total, R)
    skip = None
    for li, d in enumerate(packed["dil"].tolist()):
        hq = h.to(adt)
        tap_2d, tap_d = (F.pad(hq, (0, 0, k, 0))[:, :t_total] for k in (2 * d, d))
        if quant:
            x3 = torch.stack([tap_2d, tap_d, hq]).float().reshape(3, b * t_total, R)
            pc = (c.float() @ pw["w_c"][li]) * pw["s_c"][li]
            pre = ((torch.bmm(x3, pw["w_taps"][li]) * pw["s_taps"][li]).sum(0)
                   .reshape(b, t_total, G) + b_in[li] + pc)
        else:
            xin = torch.cat([tap_2d, tap_d, hq, c], -1).float()
            pre = xin @ pw["w_in"][li].T + b_in[li]
        gated = torch.tanh(pre[..., :G2]) * torch.sigmoid(pre[..., G2:])
        so = gated.to(adt).float() @ pw["w_so"][li].T
        so = torch.addcmul(b_so[li], so, packed["s_so"][li]) if quant else so + b_so[li]
        h = (so[..., S:] + h) * SQRT_HALF
        skip = so[..., :S] if skip is None else (skip + so[..., :S]) * scale
    o = F.relu(F.relu(skip).to(packed["w_f1"].dtype).float() @ packed["w_f1"].float().T
               + packed["b_f1"])
    return _mol_mean(o @ packed["w_f2"].T + packed["b_f2"])


# --- the kernel's wrappers ---------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("wavenet_step")
    if not getattr(lib, "_dvc_typed", False):
        lib.dvc_wavenet_generate.argtypes = (
            [_I] * 13 + [_VP, _I, ctypes.c_float, ctypes.c_ulonglong, _I] + [_I] * 6
            + [ctypes.c_longlong] + [_VP] * 21 + [_I, _VP])
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


_WEIGHTS = ("w_in", "s_in", "b_in", "w_so", "s_so", "b_so", "w_first", "b_first",
            "w_f1", "b_f1", "w_f2", "b_f2")


def wavenet_generate(packed: dict, cond: torch.Tensor, seed: int = 0,
                     deterministic: bool = False) -> torch.Tensor:
    """Autoregressive MoL generation: cond (B, T, C) float32 upsampled
    conditioning -> (B, T) waveform in [-1, 1].

    On a CUDA tensor this makes one cooperative launch of the hand-written
    kernel (the whole batch in one call; the pack's dtypes pick its
    instantiation, ``block_plan`` its split over the card's SMs) or raises;
    on a CPU tensor it runs wavenet_generate_plain.  deterministic=True takes
    the argmax mixture's mean instead of sampling."""
    if cond.device.type == "cpu":
        return wavenet_generate_plain(packed, cond, seed, deterministic)
    return _launch(packed, cond, seed, deterministic, False, 0)[0]


def wavenet_generate_checked(packed: dict, cond: torch.Tensor, seed: int = 0,
                             deterministic: bool = False, stamp_steps: int = 0):
    """wavenet_generate's launch on a CUDA tensor with its checks on:
    (out, draws, stamps).  draws (blocks, B, T) holds every block's own
    draws, which must all equal out; stamps (stamp_steps, 4 L + 4) int64 the
    SM clock of block 0 at the start of each of the first stamp_steps steps
    and at the end of each phase and barrier: [start, then per layer in,
    barrier (a), out, barrier (b), then final1, barrier, head]."""
    return _launch(packed, cond, seed, deterministic, True, stamp_steps)


def _launch(packed: dict, cond: torch.Tensor, seed: int, deterministic: bool,
            checked: bool, stamp_steps: int):
    if cond.device.type != "cuda":
        raise ValueError(f"unsupported device {cond.device}")
    L, R, G, S, C, K = _dims(packed)
    if cond.dim() != 3 or cond.shape[2] != C:
        raise ValueError(f"cond must be (B, T, {C}), got {tuple(cond.shape)}")
    if cond.dtype != torch.float32 or not cond.is_contiguous():
        raise ValueError("cond must be a contiguous float32 tensor")
    w_in, w_so = packed["w_in"], packed["w_so"]
    wdt, adt = w_in.dtype, _act_dtype(packed)
    tensors = [packed.get(k) for k in _WEIGHTS]  # s_in, s_so: int8 packs only
    if wdt == torch.int8 and (tensors[1] is None or tensors[4] is None):
        raise ValueError("an int8 pack needs its scales s_in and s_so")
    if any(p is not None and (p.device != cond.device or not p.is_contiguous()
                              or p.data_ptr() % 16) for p in tensors):
        raise ValueError("packed weights must be contiguous, 16-byte aligned and "
                         f"on {cond.device}; pack them for that device")
    vec = 16 // w_in.element_size()
    if w_in.shape[2] % vec or w_so.shape[2] % vec or S % 8 or R % 8 or C % 4 or G % 16:
        raise ValueError(f"the kernel needs whole 16-byte weight rows, skip channels and "
                         f"R % 8 == 0, C % 4 == 0 and G % 16 == 0; got {wdt} rows of "
                         f"{w_in.shape[2]} and {w_so.shape[2]}, S={S}, R={R}, C={C}, G={G}")
    b, t_total, _ = cond.shape
    dev = cond.device
    plan = block_plan(packed, b, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty(b, t_total, device=dev)
    ring = torch.empty(packed["slots"], b, R, dtype=adt, device=dev)
    h = torch.empty(b, R, dtype=adt, device=dev)
    skip = torch.empty(b, S, dtype=packed["w_f1"].dtype, device=dev)
    gated = torch.empty(b, G // 2, dtype=adt, device=dev)
    fin = torch.empty(b, S, device=dev)
    draws = torch.empty(plan["blocks"], b, t_total, device=dev) if checked else None
    steps = min(stamp_steps, t_total)
    stamps = torch.zeros(steps, 4 * L + 4, dtype=torch.int64, device=dev) if checked else None
    dil = np.ascontiguousarray(packed["dil"], np.int32)
    cfg: VocoderConfig = packed["cfg"]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dvc_wavenet_generate(
            _DTYPE_CODE[wdt], _DTYPE_CODE[packed["w_f1"].dtype], b, t_total, L, R,
            _tap_stride(cfg, wdt == torch.int8), G, w_so.shape[2], S, C, w_in.shape[2], K,
            dil.ctypes.data, int(cfg.legacy), cfg.log_scale_min, _seed64(seed),
            int(deterministic), plan["blocks"], plan["pairs"], plan["rows"], plan["cols"],
            plan["tile"], plan["resident_layers"], plan["smem_bytes"],
            *(None if p is None else p.data_ptr() for p in tensors),
            cond.data_ptr(), ring.data_ptr(), h.data_ptr(), skip.data_ptr(),
            gated.data_ptr(), fin.data_ptr(), out.data_ptr(),
            None if draws is None else draws.data_ptr(),
            None if stamps is None or not steps else stamps.data_ptr(), steps, stream)
    _check(lib, err, "wavenet_generate")
    wavenet_generate.launches[str(wdt).removeprefix("torch.")] += 1
    return out, draws, stamps


wavenet_generate.launches = collections.Counter()


def generate(model: WaveNet, c_frames: torch.Tensor | np.ndarray, seed: int = 0, *,
             weight_dtype: torch.dtype = torch.bfloat16, deterministic: bool = False,
             quantize_int8: bool = False,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, T_frames, C) mel frames -> (B, T_frames * hop) waveform in [-1, 1]:
    the port of dvc_tpu's ``pallas_generate`` (:612-702).

    The frames are upsampled once by ``model.upsample``, the weights packed
    through ``pack_wavenet_params_cached`` and the samples drawn by
    ``wavenet_generate``: on cuda the CUDA kernel, on the CPU its plain
    version.  ``model`` must live on ``device``; cuda without a card raises.
    quantize_int8 streams the layer weights as int8 codes with per-(layer,
    segment, output column) scales, with bf16 activations and ring, and
    final1 in ``weight_dtype``, as the TPU's quantized path does.

    ``pallas_generate``'s ``fuse_matmuls``, ``layers_per_block`` and
    ``resident`` are not taken: they chose TPU grid shapes (the fused
    w_cat/w_so layout, layers per grid block, weights resident or streamed)
    whose contract is "the same function", and this kernel's one design
    computes that function (tests/test_torch_port_streamed.py holds it to
    all three)."""
    dev = resolve_device(device)
    use_exact_float32()  # the upsampler's ConvTranspose2d would run in TF32
    with torch.inference_mode():
        c = torch.as_tensor(c_frames, dtype=torch.float32).to(dev)
        # packed once per weight set (memo), the ~49 MB upload with it
        packed = pack_wavenet_params_cached(model, weight_dtype, dev, quantize_int8)
        return wavenet_generate(packed, model.upsample(c).contiguous(), seed, deterministic)


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
