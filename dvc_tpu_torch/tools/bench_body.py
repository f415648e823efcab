"""P2 and P3, the port of tools/bench_body.py: the WaveNet AR kernel's
6-matmul layer body (bf16 weights and ring, float32 accumulation and h) run
over T samples of L layers, "resident" and "streamed".

  resident   P2 (make_resident, :52-102): cond = bf16(h[:, :C]) taken once
             per step, from the h the step starts with (:67);
  streamed   P3 (make_streamed, :105-172): cond taken at every layer from
             the current h (:124) -- a different function, not another
             schedule of P2's.
Each wrapper launches csrc/probe_body.cu on a CUDA tensor (P2 as one
cooperative launch of body_mma, on the tensor cores with its weights
brought by the TMA and two grid barriers a layer; P3 as two launches a
layer, streamed_in and streamed_out on body_mma's tiles, chained by
programmatic dependent launch and replayed from a CUDA graph; see there)
or raises, and runs its plain twin (resident_plain, streamed_plain) on a
CPU tensor.  ``body_plan`` and ``streamed_plan`` are the kernels' plans
(tiles, resident layers, shared memory) as the .cu file computes them,
``frag_pack`` the weights of both in the tensor cores' fragment order.
Both return
(h (1, B, R), skip (B, S)): the probe's output and the skip sum of the last
step, which the TPU kernel computes and drops.  ``resident.launches`` and
``streamed.launches`` count the wrappers' launches of their kernels (a call
of P3 is one), ``streamed.graph_us`` holds the host time of the last P3
call's graph capture and instantiation, a part of that call.

    python -m dvc_tpu_torch.tools.bench_body [resident|streamed|both] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.tools import _common
from dvc_tpu_torch.utils.device import resolve_device

B, R, G, S, C, T, L = 8, 512, 512, 256, 80, 1000, 24
SCALE = 0.7071  # the probes' literal
COND_RULES = ("step", "layer", "input")  # in the order of the kernel's codes 0, 1, 2
# csrc/probe_body.cu's body_mma constants (held to the source by the tests):
# blocks, threads, n-tiles of 8 batch rows, rows of a tile, the bf16 pad of
# a staged row, the owned state's batch stride, shared memory a block
CTAS, THREADS, MAX_NT, MAX_ROWS, PAD, OWN_B, MAX_SMEM = 128, 288, 2, 8, 8, 16, 232448
# P3's kernels (streamed_in, streamed_out): threads a block, rows of a
# streamed_in tile (8 gate pairs), and an H100 SM's shared memory and its
# reservation a block, within which a block of each kernel must fit beside
# the other
STREAMED_THREADS, IN_ROWS, SM_SMEM, RESERVED_SMEM = 256, 16, 233472, 1024


def _bf16(a: np.ndarray) -> torch.Tensor:
    # float64 -> float32 -> bfloat16, each round-to-nearest-even, as
    # jnp.asarray(x, jnp.bfloat16) gives it
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32))


def weights(rng: np.random.RandomState | None = None, *, R: int = R, G: int = G,
            S: int = S, C: int = C, layers: int = L) -> dict[str, torch.Tensor]:
    """The probe's weights on the CPU, drawn in the order and with the
    scales of tools/bench_body.py:_weights (:28-35), so that
    RandomState(0) gives the JAX probe's own weights bit for bit."""
    rng = np.random.RandomState(0) if rng is None else rng
    return dict(
        w_dil=_bf16(rng.randn(layers, 3, R, G) * 0.02),
        w_c=_bf16(rng.randn(layers, C, G) * 0.02),
        w_skip=_bf16(rng.randn(layers, G // 2, S) * 0.02),
        w_out=_bf16(rng.randn(layers, G // 2, R) * 0.02),
        b=_f32(rng.randn(layers, 1, G) * 0.01),
    )


def dims(w: dict) -> tuple[int, int, int, int, int]:
    """(L, R, G, S, C) of a weight set."""
    layers, _, r, g = w["w_dil"].shape
    return layers, r, g, w["w_skip"].shape[2], w["w_c"].shape[1]


def pack(w: dict, bias_key: str = "b") -> dict[str, torch.Tensor]:
    """The kernels' layouts: b_in (L, G) and, where the kernels' tiles take
    the widths, body_mma's w_frag (frag_pack, P2 and P4) and P3's
    streamed_in and streamed_out (streamed_pack)."""
    layers, r, g, s_ch, c = dims(w)
    out = {"b_in": w[bias_key].reshape(layers, g).float().contiguous()}
    try:
        _tiles("the kernels", 1, max(layers, 2), r, g, s_ch, c, head=False, cond_rule="step",
               rules=COND_RULES)
    except ValueError:
        return out  # widths the kernels do not take: the plain twins only
    return {**out, "w_frag": frag_pack(w), **streamed_pack(w)}


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _tiles(kernel: str, B: int, layers: int, r: int, g: int, s: int, c: int, *, head: bool,
           cond_rule: str, rules: tuple[str, ...]) -> dict:
    """The tiles of body_mma and P3's kernels, as tile_shape in the .cu file
    computes them: CTAS blocks, each with rows_in rows of phase in (its gate
    pairs' a- and g-rows), rows_out of phase out (its S / CTAS skip rows,
    then its R / CTAS channels of h) and rows_f1 of the head's final1;
    k_steps of 16 over the taps, [h | cond], gated and final1; nt n-tiles of
    8 batch rows; layer_bytes of a block's fragments a layer (f1_bytes of
    final1's).  Raises ValueError, naming ``kernel``, for shapes they do not
    take."""
    g2 = g // 2
    why = []
    if not 1 <= B <= 8 * MAX_NT:
        why.append(f"B = {B} outside [1, {8 * MAX_NT}]")
    if not 2 <= layers <= 64:
        why.append(f"{layers} layers outside [2, 64]")
    if g % 2 or g2 % CTAS or g2 % 16 or r % CTAS or s % CTAS or s % 16:
        why.append(f"G/2 = {g2}, R = {r} and S = {s} must split over {CTAS} blocks "
                   "(and G/2, S into 16-wide k-steps)")
    if r % 16 or c % 8 or c > r:
        why.append(f"R = {r} must be a multiple of 16 and C = {c} of 8, C <= R")
    if cond_rule not in rules or (head and cond_rule == "step"):
        why.append(f"cond rule {cond_rule!r}" + (" with the head" if head else ""))
    if why:
        raise ValueError(f"{kernel} does not take these shapes: " + "; ".join(why))
    pairs = g2 // CTAS
    rin, rout, rf1 = 2 * pairs, (s + r) // CTAS, s // CTAS
    if max(rin, rout) > MAX_ROWS:
        raise ValueError(f"the tiles of {kernel} hold {MAX_ROWS} rows a block, these need "
                         f"{rin} in and {rout} out")
    kt, kh, ko, kf = 2 * r // 16, (r + c + 15) // 16, g2 // 16, s // 16
    return {"rows_in": rin, "rows_out": rout, "rows_f1": rf1, "k_steps": (kt, kh, ko, kf),
            "nt": (B + 7) // 8, "layer_bytes": ((kt + kh) * rin + ko * rout) * 32,
            "f1_bytes": kf * rf1 * 32 if head else 0}


def body_plan(B: int, layers: int, r: int, g: int, s: int, c: int, *, head: bool = False,
              cond_rule: str = "step") -> dict[str, int]:
    """body_mma's plan, as persist_layout in the .cu file computes it: CTAS
    blocks with _tiles' tiles; its layer_bytes of a layer's fragments
    (f1_bytes of final1's), of which resident_layers stay in shared memory
    for the call and the rest stream through two slots; smem_bytes a block.
    Raises ValueError for shapes or a plan the kernel refuses."""
    t = _tiles("body_mma", B, layers, r, g, s, c, head=head, cond_rule=cond_rule,
               rules=COND_RULES)
    rin, rout, rf1 = t["rows_in"], t["rows_out"], t["rows_f1"]
    kt, kh, ko, kf = t["k_steps"]
    layer_bytes, f1_bytes, g2 = t["layer_bytes"], t["f1_bytes"], g // 2
    rows = 8 * t["nt"]
    fixed = (_align16(8 * MAX_NT * 64 * 4) + _align16(rows * (2 * r + PAD) * 2)
             + _align16(rows * (16 * kh + PAD) * 2) + _align16(rows * (max(g2, s) + PAD) * 2)
             + 2 * MAX_ROWS * OWN_B * 4 + OWN_B * 4 + 32 + f1_bytes)
    if fixed + layers * layer_bytes <= MAX_SMEM:
        nres, smem = layers, fixed + layers * layer_bytes
    else:
        nres = (MAX_SMEM - fixed - 2 * layer_bytes) // layer_bytes
        if nres < 0:
            raise ValueError(f"body_mma needs {fixed + 2 * layer_bytes} bytes of shared memory "
                             f"a block at B = {B}, over the {MAX_SMEM} a block can have")
        smem = fixed + (nres + 2) * layer_bytes
    return {"ctas": CTAS, "threads": THREADS, "rows_in": rin, "rows_out": rout,
            "rows_f1": rf1, "k_steps": (kt, kh, ko, kf), "layer_bytes": layer_bytes,
            "f1_bytes": f1_bytes, "resident_layers": nres, "smem_bytes": smem}


def streamed_plan(B: int, layers: int, r: int, g: int, s: int, c: int, *,
                  cond_rule: str = "layer") -> dict[str, int]:
    """P3's plan, as streamed_shape in the .cu file computes it, on blocks
    of STREAMED_THREADS threads: streamed_out on CTAS blocks with _tiles'
    out-tiles, streamed_in on in_ctas = G/2 / 8 blocks of IN_ROWS rows (8
    gate pairs' a- then g-rows); in_bytes and out_bytes of a block's
    weights a layer (streamed_pack), one bulk copy each; each kernel's
    shared memory (smem_in: partial sums, the taps, [h | cond], an mbarrier,
    the in-weights; smem_out: partial sums, gated, an mbarrier, the
    out-weights); pair_smem, what a block of each takes of an SM with the
    reservation a block, which must fit in SM_SMEM for a kernel's successor
    to start beside it.  Raises ValueError for shapes or a plan the kernels
    refuse."""
    t = _tiles("P3's kernels", B, layers, r, g, s, c, head=False, cond_rule=cond_rule,
               rules=("step", "layer"))
    kt, kh, ko, _ = t["k_steps"]
    rows = 8 * t["nt"]
    in_bytes, out_bytes = (kt + kh) * IN_ROWS * 32, ko * t["rows_out"] * 32
    smem_in = (_align16(8 * MAX_NT * IN_ROWS * 8 * 4) + _align16(rows * (2 * r + PAD) * 2)
               + _align16(rows * (16 * kh + PAD) * 2) + 16 + in_bytes)
    smem_out = (_align16(8 * MAX_NT * 64 * 4) + _align16(rows * (max(g // 2, s) + PAD) * 2)
                + 16 + out_bytes)
    pair = smem_in + smem_out + 2 * RESERVED_SMEM
    if max(smem_in, smem_out) > MAX_SMEM or pair > SM_SMEM:
        raise ValueError(f"P3's kernels need {smem_in} and {smem_out} bytes of shared memory "
                         f"a block at B = {B}: over {MAX_SMEM} a block, or {pair} over an "
                         f"SM's {SM_SMEM} for one of each")
    return {"ctas": CTAS, "in_ctas": g // 2 // (IN_ROWS // 2), "threads": STREAMED_THREADS,
            "rows_in": IN_ROWS, "rows_out": t["rows_out"], "k_steps": t["k_steps"],
            "in_bytes": in_bytes,
            "out_bytes": out_bytes, "smem_in": smem_in, "smem_out": smem_out,
            "pair_smem": pair}


def _frags(a: torch.Tensor) -> torch.Tensor:
    """(..., rows, K) -> (..., K / 16 x rows x 16) in mma.m16n8k16's A
    fragment order: k-step k, row g, lane quarter t hold A[g][16k + 2t,
    + 1, + 8, + 9], the 8 bytes one lane reads."""
    *lead, rows, k = a.shape
    n = len(lead)
    perm = list(range(n)) + [n + 1, n, n + 3, n + 2, n + 4]
    return a.reshape(*lead, rows, k // 16, 2, 4, 2).permute(perm).reshape(*lead, -1)


def _unfrags(f: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """The inverse of _frags: (..., K / 16 x rows x 16) -> (..., rows, K)."""
    *lead, _ = f.shape
    n = len(lead)
    perm = list(range(n)) + [n + 1, n, n + 3, n + 2, n + 4]
    return f.reshape(*lead, k // 16, rows, 4, 2, 2).permute(perm).reshape(*lead, rows, k)


def _in_rows(g2: int, pairs: int) -> torch.Tensor:
    """(G/2 / pairs, 2 pairs): block i's rows of phase in, its gate pairs'
    a-rows then their g-rows."""
    a = torch.arange(g2).reshape(g2 // pairs, pairs)
    return torch.cat([a, a + g2], 1)


def _out_rows(s: int, r: int) -> torch.Tensor:
    """(CTAS, rows_out): block i's rows of phase out in [w_skip | w_out]'s
    columns, its S / CTAS skip rows then its R / CTAS channels of h, so
    that the ring writes and h's publication spread over every block."""
    return torch.cat([torch.arange(s).reshape(CTAS, s // CTAS),
                      s + torch.arange(r).reshape(CTAS, r // CTAS)], 1)


def _in_frags(w: dict, pairs: int) -> torch.Tensor:
    """Phase in's weights, (L, G/2 / pairs, 2 pairs x (2R + KH)): block i's
    2 pairs rows (_in_rows) of [W0; W1; W2; Wc; 0] (K = 2R, then R + C
    padded to KH, a multiple of 16), each part in fragment order."""
    layers, r, g, _, c = dims(w)
    kh = (r + c + 15) // 16 * 16
    w_cat = torch.cat([w["w_dil"][:, 0], w["w_dil"][:, 1], w["w_dil"][:, 2], w["w_c"],
                       w["w_c"].new_zeros(layers, kh - r - c, g)], 1)  # (L, K, G)
    a_in = w_cat.transpose(1, 2)[:, _in_rows(g // 2, pairs)]  # (L, blocks, 2 pairs, K)
    return torch.cat([_frags(a_in[..., :2 * r]), _frags(a_in[..., 2 * r:])], 2)


def _out_frags(w: dict) -> torch.Tensor:
    """Phase out's weights, (L, CTAS, rows_out x G/2): block i's rows
    (_out_rows) of [w_skip | w_out], in fragment order."""
    _, r, _, s_ch, _ = dims(w)
    a_out = torch.cat([w["w_skip"], w["w_out"]], 2).transpose(1, 2)  # (L, S + R, G/2)
    return _frags(a_out[:, _out_rows(s_ch, r)])


def _unpack(f_in: torch.Tensor, f_out: torch.Tensor, pairs: int, r: int, g: int, s: int,
            c: int) -> dict[str, torch.Tensor]:
    """The weights _in_frags(., pairs) and _out_frags packed, as w_dil, w_c,
    w_skip and w_out."""
    layers, g2 = f_in.shape[0], g // 2
    kh = (r + c + 15) // 16 * 16
    rin, rout = 2 * pairs, (s + r) // CTAS
    n_taps = rin * 2 * r
    a_in = torch.cat([_unfrags(f_in[..., :n_taps], rin, 2 * r),
                      _unfrags(f_in[..., n_taps:], rin, kh)], 3)
    w_cat = f_in.new_zeros(layers, g, 2 * r + kh)
    w_cat[:, _in_rows(g2, pairs)] = a_in
    w_cat = w_cat.transpose(1, 2)
    a_out = f_out.new_zeros(layers, s + r, g2)
    a_out[:, _out_rows(s, r)] = _unfrags(f_out, rout, g2)
    so = a_out.transpose(1, 2)
    return {"w_dil": torch.stack([w_cat[:, :r], w_cat[:, r:2 * r], w_cat[:, 2 * r:3 * r]], 1),
            "w_c": w_cat[:, 3 * r:3 * r + c], "w_skip": so[..., :s], "w_out": so[..., s:]}


def frag_pack(w: dict) -> torch.Tensor:
    """body_mma's weights: (L, CTAS, layer_bytes / 2) bf16, block i's run of
    a layer = [phase in: its rows_in rows of [W0; W1; W2; Wc; 0] (K = 2R
    then R + C padded to 16) | phase out: its rows_out rows of [w_skip |
    w_out]], each in fragment order (see _frags)."""
    return torch.cat([_in_frags(w, w["w_dil"].shape[3] // 2 // CTAS), _out_frags(w)],
                     2).contiguous()


def frag_unpack(frag: torch.Tensor, r: int, g: int, s: int, c: int) -> dict[str, torch.Tensor]:
    """The weights frag_pack packed, as w_dil, w_c, w_skip and w_out."""
    pairs = g // 2 // CTAS
    n_in = 2 * pairs * (2 * r + (r + c + 15) // 16 * 16)
    return _unpack(frag[..., :n_in], frag[..., n_in:], pairs, r, g, s, c)


def streamed_pack(w: dict) -> dict[str, torch.Tensor]:
    """P3's weights, by the kernel that reads them: streamed_in (L, G/2 / 8,
    in_bytes / 2) bf16, block i's IN_ROWS rows (gate pairs [8i, 8i + 8),
    a-rows then g-rows) as frag_pack lays out phase in, and streamed_out
    (L, CTAS, out_bytes / 2), its rows as frag_pack lays out phase out."""
    return {"streamed_in": _in_frags(w, IN_ROWS // 2).contiguous(),
            "streamed_out": _out_frags(w).contiguous()}


def streamed_unpack(packed: dict, r: int, g: int, s: int, c: int) -> dict[str, torch.Tensor]:
    """The weights streamed_pack packed, as w_dil, w_c, w_skip and w_out."""
    return _unpack(packed["streamed_in"], packed["streamed_out"], IN_ROWS // 2, r, g, s, c)


def f1_frag_pack(w_f1: torch.Tensor) -> torch.Tensor:
    """The head's final1 for body_mma: (CTAS, f1_bytes / 2) bf16, block i's
    rows_f1 output columns of w_f1 (S, S), (in, out), in fragment order."""
    s = w_f1.shape[0]
    return _frags(w_f1.t().reshape(CTAS, s // CTAS, s)).contiguous()


def prepare(w: dict, device: str | torch.device) -> dict[str, torch.Tensor]:
    """w on ``device`` with the kernel's pack beside it (the wrappers read
    the probe's layout on the CPU and the pack on a card)."""
    w = {k: v.to(device) for k, v in w.items()}
    return {**w, **pack(w)}


def body_plain(h, x1, x2, cond, w_dil, w_c, w_skip, w_out, b):
    """tools/bench_body.py:_body (:38-49): float32 weights (the bf16 ones
    upcast, exact), bf16 activations, float32 sums -> (res + h, s)."""
    conv = (x2.float() @ w_dil[0] + x1.float() @ w_dil[1]
            + h.to(torch.bfloat16).float() @ w_dil[2] + cond.float() @ w_c + b[0])
    g2 = conv.shape[1] // 2
    gated = (torch.tanh(conv[:, :g2]) * torch.sigmoid(conv[:, g2:])).to(torch.bfloat16).float()
    return gated @ w_out + h, gated @ w_skip


@torch.no_grad()
def _plain(w: dict, cond_rule: str, *, B: int, T: int, dil) -> tuple[torch.Tensor, torch.Tensor]:
    if cond_rule not in ("step", "layer"):
        raise ValueError(f"P2 and P3 take cond rule 'step' or 'layer', got {cond_rule!r}")
    dil = _common.dil_array(dil)
    offs = _common.offsets(dil)
    _, r, _, s_ch, c = dims(w)
    w_dil, w_c, w_skip, w_out = (w[k].float() for k in ("w_dil", "w_c", "w_skip", "w_out"))
    dev = w_dil.device
    ring = torch.zeros(int(2 * dil.sum()), B, r, dtype=torch.bfloat16, device=dev)
    h = torch.ones(B, r, device=dev)
    skip = torch.zeros(B, s_ch, device=dev)
    for t in range(T):
        skip = torch.zeros(B, s_ch, device=dev)
        cond = h[:, :c].to(torch.bfloat16)
        for li in range(len(dil)):
            if cond_rule == "layer":
                cond = h[:, :c].to(torch.bfloat16)
            s2, s1 = _common.taps_of(t, int(dil[li]), int(offs[li]))
            new_h, s = body_plain(h, ring[s1], ring[s2], cond, w_dil[li], w_c[li],
                                  w_skip[li], w_out[li], w["b"][li])
            ring[s2] = h.to(torch.bfloat16)
            h = new_h * SCALE
            skip = skip + s
    return h[None], skip


def resident_plain(w: dict, *, B: int, T: int, dil):
    """P2's function in PyTorch: cond from the h each step starts with."""
    return _plain(w, "step", B=B, T=T, dil=dil)


def streamed_plain(w: dict, *, B: int, T: int, dil):
    """P3's function in PyTorch: cond from the current h at every layer."""
    return _plain(w, "layer", B=B, T=T, dil=dil)


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not getattr(lib, "_dvc_typed", False):
        i32, vp = _common.I32, _common.VP
        lib.dvc_probe_body_persistent.argtypes = [i32] * 12 + [vp, i32] + [vp] * 17
        lib.dvc_probe_body_persistent.restype = i32
        lib.dvc_probe_body_streamed.argtypes = [i32] * 8 + [vp, i32] + [vp] * 12
        lib.dvc_probe_body_streamed.restype = i32
        lib.dvc_probe_body_plan.argtypes = [i32] * 8 + [vp]
        lib.dvc_probe_body_plan.restype = i32
        lib.dvc_probe_streamed_plan.argtypes = [i32] * 7 + [vp]
        lib.dvc_probe_streamed_plan.restype = i32
        lib.dvc_probe_body_error_string.argtypes = [i32]
        lib.dvc_probe_body_error_string.restype = ctypes.c_char_p
        lib._dvc_typed = True
    return lib


def launch(w: dict, *, persistent: bool, cond_rule: str, bias: bool, scaled_skip: bool,
           row_out: bool, head: bool, B: int, T: int, dil, what: str,
           lib: ctypes.CDLL | None = None):
    """One call of csrc/probe_body.cu on the pack in ``w`` (see prepare), on a
    card: (out, skip), out the final h (1, B, R) or, with row_out, (T, 1, B).
    persistent: body_mma (P2, P4); else P3's streamed_in/streamed_out from
    a CUDA graph (the bias, the plain skip sum, no row output, no head).
    ``lib``: a build of an edited
    copy of the source (ablate_body's variants) in place of the source's
    own."""
    if cond_rule not in COND_RULES:
        raise ValueError(f"cond_rule must be one of {COND_RULES}, got {cond_rule!r}")
    if B < 1 or T < 0:
        raise ValueError(f"need B >= 1 and T >= 0, got B={B}, T={T}")
    if "b_in" not in w:
        raise ValueError("w carries no kernel pack: make it with prepare()")
    dil = _common.dil_array(dil)
    layers, r, g, s_ch, c = dims(w)
    if len(dil) != layers:
        raise ValueError(f"{len(dil)} dilations for {layers} layers")
    dev = w["b_in"].device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    bf, f32 = torch.bfloat16, torch.float32
    ptr = _common.cuda_checked
    slots = int(2 * dil.sum())
    ring = torch.empty(slots, B, r, dtype=bf, device=dev)
    h = torch.empty(1, B, r, device=dev)
    skip = torch.empty(B, s_ch, device=dev)
    lib = _typed(lib or _build.load("probe_body"))
    if not persistent:
        if not bias or scaled_skip or row_out or head or cond_rule == "input":
            raise ValueError("P3's kernels run the bias, the plain skip sum, cond "
                             "rule 'step' or 'layer', no row output and no head")
        streamed_plan(B, layers, r, g, s_ch, c, cond_rule=cond_rule)
        scratch = [torch.empty(B, n, dtype=bf, device=dev) for n in (r, c, g // 2)]  # hb condb gb
        tbase = torch.empty(4, dtype=torch.int32, device=dev)  # the step the graph runs
        graph_us = ctypes.c_double(0.0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dvc_probe_body_streamed(
                COND_RULES.index(cond_rule), B, T, layers, r, g, s_ch, c, dil.ctypes.data, slots,
                ptr(w["streamed_in"], "streamed_in", dev, bf),
                ptr(w["streamed_out"], "streamed_out", dev, bf),
                ptr(w["b_in"], "b_in", dev, f32), ring.data_ptr(),
                *(x.data_ptr() for x in scratch), tbase.data_ptr(), h.data_ptr(),
                skip.data_ptr(), stream, ctypes.addressof(graph_us))
        _common.check(lib, err, what, "dvc_probe_body_error_string")
        streamed.graph_us = graph_us.value
        return h, skip
    body_plan(B, layers, r, g, s_ch, c, head=head, cond_rule=cond_rule)
    ptrs = [ptr(w["w_frag"], "w_frag", dev, bf),
            ptr(w["w_f1_frag"], "w_f1_frag", dev, bf) if head else None,
            ptr(w["b_in"], "b_in", dev, f32) if bias else None]
    if cond_rule == "input":
        if tuple(w["cond_in"].shape) != (T, B, c):
            raise ValueError(f"cond_in must be ({T}, {B}, {c}), got {tuple(w['cond_in'].shape)}")
        ptrs.append(ptr(w["cond_in"], "cond_in", dev, f32))
    else:
        ptrs.append(None)
    if head:
        ptrs += [ptr(w["w_first_v"], "w_first", dev, f32), ptr(w["w_f2_0"], "w_f2", dev, f32)]
    else:
        ptrs += [None] * 2
    scratch = [torch.empty(B, n, dtype=bf, device=dev) for n in (r, c, g // 2, s_ch)]
    o1 = torch.empty(B, s_ch, device=dev)
    bar = torch.empty(4, dtype=torch.int32, device=dev)  # the grid barrier's arrival count
    out = torch.empty(T, 1, B, device=dev) if row_out else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dvc_probe_body_persistent(
            COND_RULES.index(cond_rule), int(bias), int(scaled_skip), int(row_out), int(head),
            B, T, layers, r, g, s_ch, c, dil.ctypes.data, slots, *ptrs, ring.data_ptr(),
            *(x.data_ptr() for x in scratch), o1.data_ptr(), bar.data_ptr(), h.data_ptr(),
            skip.data_ptr(), None if out is None else out.data_ptr(), stream)
    _common.check(lib, err, what, "dvc_probe_body_error_string")
    return (out if row_out else h), skip


def device_plan(B: int, layers: int, r: int, g: int, s: int, c: int, *, head: bool = False,
                cond_rule: str = "step", device: str | torch.device = "cuda") -> dict[str, int]:
    """body_mma's plan as the card's build computes it: body_plan's keys
    that the kernel reports, plus blocks_per_sm (cudaOccupancyMaxActive-
    BlocksPerMultiprocessor)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the device plan is the card's: it needs a CUDA device")
    lib = _typed(_build.load("probe_body"))
    plan = (ctypes.c_int * 9)()
    with torch.cuda.device(dev):
        err = lib.dvc_probe_body_plan(B, layers, r, g, s, c, int(head),
                                      COND_RULES.index(cond_rule), ctypes.addressof(plan))
    _common.check(lib, err, "bench_body plan", "dvc_probe_body_error_string")
    keys = ("ctas", "threads", "rows_in", "rows_out", "rows_f1", "layer_bytes",
            "resident_layers", "smem_bytes", "blocks_per_sm")
    return dict(zip(keys, plan))


def streamed_device_plan(B: int, layers: int, r: int, g: int, s: int, c: int, *,
                         cond_rule: str = "layer",
                         device: str | torch.device = "cuda") -> dict[str, int]:
    """P3's plan as the card's build computes it: streamed_plan's keys that
    the kernels report, their registers a thread (regs_in, regs_out), the
    card's blocks an SM for each, pair_fits (1 where a block of each fits on
    an SM beside the other: shared memory with the reservation, threads,
    registers), the SM's shared memory and reservation, and the L2's bytes
    and its largest persisting window."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the device plan is the card's: it needs a CUDA device")
    lib = _typed(_build.load("probe_body"))
    plan = (ctypes.c_int * 18)()
    with torch.cuda.device(dev):
        err = lib.dvc_probe_streamed_plan(B, layers, r, g, s, c, COND_RULES.index(cond_rule),
                                          ctypes.addressof(plan))
    _common.check(lib, err, "bench_body streamed plan", "dvc_probe_body_error_string")
    keys = ("ctas", "in_ctas", "threads", "rows_in", "rows_out", "in_bytes", "out_bytes",
            "smem_in", "smem_out", "regs_in", "regs_out", "blocks_per_sm_in",
            "blocks_per_sm_out", "pair_fits", "sm_smem", "reserved_smem", "l2_bytes",
            "persisting_l2_bytes")
    return dict(zip(keys, plan))


def _on_cuda(w: dict) -> bool:
    dev = w["w_dil"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def resident(w: dict, *, B: int, T: int, dil, cond_rule: str = "step"):
    """P2 over T steps -> (h (1, B, R), skip (B, S)).  On a CUDA tensor one
    cooperative launch of body_mma, or an error; on a CPU tensor the plain
    twin.  ``cond_rule`` other than "step" is the wrong rule, for checks."""
    if not _on_cuda(w):
        return _plain(w, cond_rule, B=B, T=T, dil=dil)
    res = launch(w, persistent=True, cond_rule=cond_rule, bias=True, scaled_skip=False,
                 row_out=False, head=False, B=B, T=T, dil=dil, what="bench_body resident")
    resident.launches += 1
    return res


def streamed(w: dict, *, B: int, T: int, dil, cond_rule: str = "layer"):
    """P3 over T steps -> (h (1, B, R), skip (B, S)).  On a CUDA tensor two
    kernel launches a layer chained by programmatic dependent launch, a
    step's CUDA graph replayed T times, or an error; on a CPU
    tensor the plain twin.  ``cond_rule`` other than "layer" is the wrong
    rule."""
    if not _on_cuda(w):
        return _plain(w, cond_rule, B=B, T=T, dil=dil)
    res = launch(w, persistent=False, cond_rule=cond_rule, bias=True, scaled_skip=False,
                 row_out=False, head=False, B=B, T=T, dil=dil, what="bench_body streamed")
    streamed.launches += 1
    return res


resident.launches = 0
streamed.launches = 0
streamed.graph_us = 0.0


def _make(fn, *, B, R, G, S, C, T, layers, device):
    dev = resolve_device(device)
    w = prepare(weights(R=R, G=G, S=S, C=C, layers=layers), dev)
    dil, _ = _common.geometry(layers)
    return lambda: fn(w, B=B, T=T, dil=dil)[0]


def make_resident(*, B: int = B, R: int = R, G: int = G, S: int = S, C: int = C, T: int = T,
                  layers: int = L, device: str | torch.device = "cuda"):
    """P2's callable: f() -> (1, B, R), as tools/bench_body.make_resident()
    returns, on the probe's own weights.  cuda without a card raises."""
    return _make(resident, B=B, R=R, G=G, S=S, C=C, T=T, layers=layers, device=device)


def make_streamed(*, B: int = B, R: int = R, G: int = G, S: int = S, C: int = C, T: int = T,
                  layers: int = L, device: str | torch.device = "cuda"):
    """P3's callable: f() -> (1, B, R), as tools/bench_body.make_streamed()."""
    return _make(streamed, B=B, R=R, G=G, S=S, C=C, T=T, layers=layers, device=device)


def bench(name: str, f, *, T: int = T, layers: int = L,
          device: str | torch.device = "cuda") -> dict:
    """One warm call, then the best of 3, printed as the JAX probe prints it
    (the first call's time stands where it prints the compile time)."""
    dev = resolve_device(device)
    first, best = _common.time_best(f, dev)
    per_samp = best / T * 1e6
    print(f"{name:10s}: {per_samp:8.2f} us/sample, {per_samp / layers * 1000:7.0f} "
          f"ns/layer, {1e6 / per_samp:8.0f} samples/s/utt  (first call {first:.1f}s)",
          flush=True)
    return {"name": name, "ms": best * 1e3, "us_per_step": per_samp,
            "ns_per_layer": per_samp / layers * 1000}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="both", choices=("both", "resident", "streamed"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}", flush=True)
    if args.which in ("both", "resident"):
        bench("resident", make_resident(device=dev), device=dev)
    if args.which in ("both", "streamed"):
        bench("streamed", make_streamed(device=dev), device=dev)


if __name__ == "__main__":
    main()
