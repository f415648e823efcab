"""P4, the port of tools/bench_body2.py: the resident layer body of P2 with
production features added stage by stage (make(stage), :29-129):

  stage 0  P2's body without the bias, the skip sum scaled as skip = s, then
           (skip + s) * 0.7071 (:85), cond = bf16(h[:, :C]) at the step's
           start; output the final h (1, B, R);
  stage 1  + cond streamed from cond_in (T, B, C) (:61-62);
  stage 2  + the output (T, 1, B): batch row 0's first B channels of h after
           each step (:96-97);
  stage 3  + h rebuilt each step from the fed-back sample, h = x * w_first,
           after the head relu -> final1 (bf16) -> relu -> final2 (float32)
           -> clip of column 0 (:57-58, :87-93);
  stage 4  + the per-layer bias (:77-78).

``body2`` launches csrc/probe_body.cu on a CUDA tensor (one cooperative
launch of body_mma, as P2) or raises, and runs body2_plain on a CPU tensor;
both return (out, skip), skip (B, S) being the last step's skip sum.
``body2.launches`` counts kernel launches by stage.

    python -m dvc_tpu_torch.tools.bench_body2 [stage ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import collections

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.tools import _common
from dvc_tpu_torch.tools import bench_body as _body
from dvc_tpu_torch.utils.device import resolve_device

B, R, G, S, C, T, L = _body.B, _body.R, _body.G, _body.S, _body.C, _body.T, _body.L
STAGES = (0, 1, 2, 3, 4)
SCALE = _body.SCALE


def weights(rng: np.random.RandomState | None = None, *, B: int = B, R: int = R, G: int = G,
            S: int = S, C: int = C, T: int = T, layers: int = L) -> dict[str, torch.Tensor]:
    """The probe's weights and cond_in on the CPU, drawn in the order and
    with the scales of tools/bench_body2.py:30-39 (RandomState(0) gives the
    JAX probe's own, bit for bit); names as there."""
    rng = np.random.RandomState(0) if rng is None else rng
    bf, f32 = _body._bf16, _body._f32
    return dict(
        w_dil=bf(rng.randn(layers, 3, R, G) * 0.02),
        w_c=bf(rng.randn(layers, C, G) * 0.02),
        w_skip=bf(rng.randn(layers, G // 2, S) * 0.02),
        w_out=bf(rng.randn(layers, G // 2, R) * 0.02),
        b_dil=f32(rng.randn(layers, 1, G) * 0.01),
        w_first=f32(rng.randn(1, R) * 0.1),
        w_f1=bf(rng.randn(S, S) * 0.05),
        w_f2=f32(rng.randn(S, 128) * 0.05),
        cond_in=f32(rng.rand(T, B, C)),
    )


def prepare(w: dict, device: str | torch.device) -> dict[str, torch.Tensor]:
    """w on ``device`` with the kernel's pack beside it: bench_body.pack
    with b_dil as the bias, w_f1 in body_mma's fragment order (where it
    takes the widths), final2's column 0 (the only one the head reads) and
    w_first as a vector."""
    w = {k: v.to(device).contiguous() for k, v in w.items()}
    packed = _body.pack(w, "b_dil")
    if "w_frag" in packed:
        packed["w_f1_frag"] = _body.f1_frag_pack(w["w_f1"])
    return {**w, **packed, "w_f2_0": w["w_f2"][:, 0].contiguous(),
            "w_first_v": w["w_first"].reshape(-1).contiguous()}


@torch.no_grad()
def body2_plain(w: dict, stage: int, *, B: int, T: int, dil) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's function in PyTorch, as tools/bench_body2.py:43-99 computes
    it: (out, skip), out (1, B, R) below stage 2, else (T, 1, B)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage}")
    dil = _common.dil_array(dil)
    offs = _common.offsets(dil)
    _, r, _, s_ch, c = _body.dims(w)
    g2 = w["w_dil"].shape[3] // 2
    w_dil, w_c, w_skip, w_out, w_f1 = (w[k].float()
                                       for k in ("w_dil", "w_c", "w_skip", "w_out", "w_f1"))
    dev = w_dil.device
    bf = torch.bfloat16
    ring = torch.zeros(int(2 * dil.sum()), B, r, dtype=bf, device=dev)
    h_scr = torch.ones(B, r, device=dev)
    xp = torch.zeros(B, device=dev)
    skip = torch.zeros(B, s_ch, device=dev)
    rows = []
    for t in range(T):
        h = xp[:, None] * w["w_first"][0][None, :] if stage >= 3 else h_scr
        cond = (w["cond_in"][t] if stage >= 1 else h_scr[:, :c]).to(bf).float()
        skip = None
        for li in range(len(dil)):
            s2, s1 = _common.taps_of(t, int(dil[li]), int(offs[li]))
            conv = (ring[s2].float() @ w_dil[li, 0] + ring[s1].float() @ w_dil[li, 1]
                    + h.to(bf).float() @ w_dil[li, 2] + cond @ w_c[li])
            if stage >= 4:
                conv = conv + w["b_dil"][li, 0]
            gated = (torch.tanh(conv[:, :g2]) * torch.sigmoid(conv[:, g2:])).to(bf).float()
            s = gated @ w_skip[li]
            res = gated @ w_out[li]
            ring[s2] = h.to(bf)
            h = (res + h) * SCALE
            skip = s if skip is None else (skip + s) * SCALE
        if stage >= 3:
            o = F.relu(skip)
            o = F.relu(o.to(bf).float() @ w_f1)
            y = o @ w["w_f2"]
            xp = torch.clamp(y[:, 0], -1.0, 1.0)
        h_scr = h
        if stage >= 2:
            rows.append(h[0, :B].clone())
    if stage >= 2:
        out = torch.stack(rows)[:, None, :] if rows else torch.zeros(0, 1, B, device=dev)
    else:
        out = h_scr[None]
    return out, skip


def body2(w: dict, stage: int, *, B: int, T: int, dil) -> tuple[torch.Tensor, torch.Tensor]:
    """P4 at ``stage`` over T steps -> (out, skip).  On a CUDA tensor one
    cooperative launch of body_mma, or an error; on a CPU tensor
    body2_plain."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage}")
    if not _body._on_cuda(w):
        return body2_plain(w, stage, B=B, T=T, dil=dil)
    if stage >= 2 and B > _body.dims(w)[1]:
        raise ValueError(f"stage {stage} outputs B={B} channels of h, more than R")
    res = _body.launch(w, persistent=True, cond_rule="input" if stage >= 1 else "step",
                       bias=stage >= 4, scaled_skip=True, row_out=stage >= 2, head=stage >= 3,
                       B=B, T=T, dil=dil, what=f"bench_body2 stage {stage}")
    body2.launches[stage] += 1
    return res


body2.launches = collections.Counter()


def make(stage: int, *, B: int = B, R: int = R, G: int = G, S: int = S, C: int = C,
         T: int = T, layers: int = L, device: str | torch.device = "cuda"):
    """The probe's callable: f() -> out, as tools/bench_body2.make(stage)
    returns, on the probe's own weights and cond_in.  cuda without a card
    raises."""
    dev = resolve_device(device)
    w = prepare(weights(B=B, R=R, G=G, S=S, C=C, T=T, layers=layers), dev)
    dil, _ = _common.geometry(layers)
    return lambda: body2(w, stage, B=B, T=T, dil=dil)[0]


def bench(stage: int, *, T: int = T, device: str | torch.device = "cuda", **sizes) -> dict:
    """One warm call, then the best of 3, printed as the JAX probe prints it."""
    dev = resolve_device(device)
    _, best = _common.time_best(make(stage, T=T, device=dev, **sizes), dev)
    us = best / T * 1e6
    print(f"stage{stage}: {us:8.2f} us/sample  {1e6 / us:8.0f} samples/s/utt", flush=True)
    return {"stage": stage, "ms": best * 1e3, "us_per_step": us}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", type=int, choices=STAGES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}", flush=True)
    for st in args.stages or STAGES:
        bench(st, device=dev)


if __name__ == "__main__":
    main()
