"""P2 and P3, the port of tools/bench_body.py: the WaveNet AR kernel's
6-matmul layer body (bf16 weights and ring, float32 accumulation and h) run
over T samples of L layers, "resident" and "streamed".

  resident   P2 (make_resident, :52-102): cond = bf16(h[:, :C]) taken once
             per step, from the h the step starts with (:67);
  streamed   P3 (make_streamed, :105-172): cond taken at every layer from
             the current h (:124) -- a different function, not another
             schedule of P2's.
Each wrapper launches csrc/probe_body.cu on a CUDA tensor (P2 as one
cooperative launch with a grid barrier between dependent phases, P3 as two
launches per layer from a host loop in C; see there) or raises, and runs its
plain twin (resident_plain, streamed_plain) on a CPU tensor.  Both return
(h (1, B, R), skip (B, S)): the probe's output and the skip sum of the last
step, which the TPU kernel computes and drops.  ``resident.launches`` and
``streamed.launches`` count kernel launches.

    python -m dvc_tpu_torch.tools.bench_body [resident|streamed|both] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.tools import _common
from dvc_tpu_torch.utils.device import resolve_device

B, R, G, S, C, T, L = 8, 512, 512, 256, 80, 1000, 24
SCALE = 0.7071  # the probes' literal
COND_RULES = ("step", "layer", "input")  # in the order of the kernel's codes 0, 1, 2


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
    """The kernel's output-major layout: w_in (L, G, KIp) rows [W0[:, j] |
    W1[:, j] | W2[:, j] | Wc[:, j] | 0] with KIp = 3R + C rounded up to 8,
    w_so (L, S + R, G/2) rows [w_skip[:, s] ; w_out[:, r]], b_in (L, G)."""
    layers, r, g, _, c = dims(w)
    w_in = torch.cat([w["w_dil"].permute(0, 3, 1, 2).reshape(layers, g, 3 * r),
                      w["w_c"].transpose(1, 2)], 2)
    return {"w_in": F.pad(w_in, (0, -(3 * r + c) % 8)).contiguous(),
            "w_so": torch.cat([w["w_skip"].transpose(1, 2), w["w_out"].transpose(1, 2)],
                              1).contiguous(),
            "b_in": w[bias_key].reshape(layers, g).float().contiguous()}


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
        lib.dvc_probe_body.argtypes = [_common.I32] * 14 + [_common.VP, _common.I32] + \
            [_common.VP] * 15
        lib.dvc_probe_body.restype = _common.I32
        lib.dvc_probe_body_error_string.argtypes = [_common.I32]
        lib.dvc_probe_body_error_string.restype = ctypes.c_char_p
        lib._dvc_typed = True
    return lib


def launch(w: dict, *, persistent: bool, cond_rule: str, bias: bool, scaled_skip: bool,
           row_out: bool, head: bool, B: int, T: int, dil, what: str,
           lib: ctypes.CDLL | None = None):
    """One call of csrc/probe_body.cu on the pack in ``w`` (see prepare), on a
    card: (out, skip), out the final h (1, B, R) or, with row_out, (T, 1, B).
    ``lib``: a build of an edited copy of the source (ablate_body's
    variants) in place of the source's own."""
    if cond_rule not in COND_RULES:
        raise ValueError(f"cond_rule must be one of {COND_RULES}, got {cond_rule!r}")
    if B < 1 or T < 0:
        raise ValueError(f"need B >= 1 and T >= 0, got B={B}, T={T}")
    if "w_in" not in w:
        raise ValueError("w carries no kernel pack: make it with prepare()")
    dil = _common.dil_array(dil)
    layers, r, g, s_ch, c = dims(w)
    if len(dil) != layers:
        raise ValueError(f"{len(dil)} dilations for {layers} layers")
    dev = w["w_in"].device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    bf, f32 = torch.bfloat16, torch.float32
    ptr = _common.cuda_checked
    ptrs = [ptr(w["w_in"], "w_in", dev, bf), ptr(w["w_so"], "w_so", dev, bf),
            ptr(w["b_in"], "b_in", dev, f32) if bias else None]
    if cond_rule == "input":
        if tuple(w["cond_in"].shape) != (T, B, c):
            raise ValueError(f"cond_in must be ({T}, {B}, {c}), got {tuple(w['cond_in'].shape)}")
        ptrs.append(ptr(w["cond_in"], "cond_in", dev, f32))
    else:
        ptrs.append(None)
    if head:
        ptrs += [ptr(w["w_first_v"], "w_first", dev, f32), ptr(w["w_f1_t"], "w_f1", dev, bf),
                 ptr(w["w_f2_0"], "w_f2", dev, f32)]
    else:
        ptrs += [None] * 3
    slots = int(2 * dil.sum())
    ring = torch.empty(slots, B, r, dtype=bf, device=dev)
    h = torch.empty(1, B, r, device=dev)
    skip = torch.empty(B, s_ch, device=dev)
    gated = torch.empty(B, g // 2, device=dev)
    cond = torch.empty(B, c, device=dev)
    o1 = torch.empty(B, s_ch, device=dev)
    out = torch.empty(T, 1, B, device=dev) if row_out else None
    lib = _typed(lib or _build.load("probe_body"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dvc_probe_body(
            int(persistent), COND_RULES.index(cond_rule), int(bias), int(scaled_skip), int(row_out),
            int(head), B, T, layers, r, g, s_ch, c, w["w_in"].shape[2], dil.ctypes.data, slots,
            *ptrs, ring.data_ptr(), h.data_ptr(), skip.data_ptr(), gated.data_ptr(),
            cond.data_ptr(), o1.data_ptr(), None if out is None else out.data_ptr(), stream)
    _common.check(lib, err, what, "dvc_probe_body_error_string")
    return (out if row_out else h), skip


def _on_cuda(w: dict) -> bool:
    dev = w["w_dil"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def resident(w: dict, *, B: int, T: int, dil, cond_rule: str = "step"):
    """P2 over T steps -> (h (1, B, R), skip (B, S)).  On a CUDA tensor one
    cooperative launch of the kernel, or an error; on a CPU tensor the plain
    twin.  ``cond_rule`` other than "step" is the wrong rule, for checks."""
    if not _on_cuda(w):
        return _plain(w, cond_rule, B=B, T=T, dil=dil)
    res = launch(w, persistent=True, cond_rule=cond_rule, bias=True, scaled_skip=False,
                 row_out=False, head=False, B=B, T=T, dil=dil, what="bench_body resident")
    resident.launches += 1
    return res


def streamed(w: dict, *, B: int, T: int, dil, cond_rule: str = "layer"):
    """P3 over T steps -> (h (1, B, R), skip (B, S)).  On a CUDA tensor two
    kernel launches per layer from a host loop, or an error; on a CPU tensor
    the plain twin.  ``cond_rule`` other than "layer" is the wrong rule."""
    if not _on_cuda(w):
        return _plain(w, cond_rule, B=B, T=T, dil=dil)
    res = launch(w, persistent=False, cond_rule=cond_rule, bias=True, scaled_skip=False,
                 row_out=False, head=False, B=B, T=T, dil=dil, what="bench_body streamed")
    streamed.launches += 1
    return res


resident.launches = 0
streamed.launches = 0


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
