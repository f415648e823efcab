"""Where a layer's time goes in P2 and P3 (csrc/probe_body.cu).  Each variant
removes one part of the kernel by an edit of its source, and is timed as P2
(one persistent launch, two grid barriers a layer) and, where the edit
reaches the per-layer kernels, as P3 (two launches a layer), at the probes'
widths and weights, B = 8, over T steps.  A variant's output is wrong by
design: only its time is read.

  base        the kernel as it is
  barriers    no phase work: P2 runs only its grid barriers, P3 only its
              empty launches
  no_in       P2 without phase `in` (its barrier stays)
  no_out      P2 without phase `out` (its barrier stays)
  no_stage    phase `in` stages no inputs; the weights are still read
  no_weights  the phases read no weights, a constant in place of each vector
  no_barrier  P2 with each grid barrier cut to a block barrier

    python -m dvc_tpu_torch.tools.ablate_body [--T 200]

Each variant's source is written and built under build/kernels/ablate/,
one nvcc each, all at once.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
from concurrent.futures import ThreadPoolExecutor

import torch

from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.tools import _common
from dvc_tpu_torch.tools import bench_body as pb
from dvc_tpu_torch.utils.device import resolve_device

SOURCE = _build.CSRC / "probe_body.cu"
_STAGE = ("  stage_in(p, p.ring + (size_t)s2 * hsz, p.ring + (size_t)s1 * hsz, "
          "csrc, cstride, xs);")
_IN = "      phase_in(p, t, l, sm);\n      grid.sync();"
_OUT = "      phase_out(p, t, l, sm);\n      grid.sync();"
_WEIGHT_LOAD = ("use_pre && v == first ? pre[r]\n"
                "                                        : __ldg(reinterpret_cast<const uint4*>"
                "(w[r]) + v)")
_WEIGHT_PRE = ("    pre[r] = first < n / 8 ? __ldg(reinterpret_cast<const uint4*>(w[r]) + first)\n"
               "                           : make_uint4(0u, 0u, 0u, 0u);")
_ONE = "make_uint4(0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u)"

# name -> (the (old, new) edits of the source, whether P3 is timed)
VARIANTS: dict[str, tuple[tuple[tuple[str, str], ...], bool]] = {
    "base": ((), True),
    "barriers": (((_IN, "      grid.sync();"), (_OUT, "      grid.sync();"),
                  ("  phase_in(p, t, l, sm);\n}", "}"), ("  phase_out(p, t, l, sm);\n}", "}")),
                 True),
    "no_in": (((_IN, "      grid.sync();"),), False),
    "no_out": (((_OUT, "      grid.sync();"),), False),
    "no_stage": (((_STAGE, ""),), True),
    "no_weights": (((_WEIGHT_LOAD, _ONE), (_WEIGHT_PRE, "    pre[r] = " + _ONE + ";")), True),
    "no_barrier": ((("      grid.sync();  // (a)", "      __syncthreads();  // (a)"),
                    ("      grid.sync();  // (b)", "      __syncthreads();  // (b)")), False),
}


def variant_source(name: str) -> str:
    """The kernel's source with ``name``'s edits; each edit must match the
    source exactly once, so an edit the source has outgrown fails here."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: its edit matches the source "
                             f"{src.count(old)} times, not once:\n{old}")
        src = src.replace(old, new)
    return src


def _library(name: str) -> ctypes.CDLL:
    src = variant_source(name)
    digest = hashlib.sha256(src.encode() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    out = _build.BUILD_DIR / "ablate" / f"lib{name}_{digest[:16]}.so"
    if not out.exists():
        cu = out.with_suffix(".cu")
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        _build.compile_library(cu, out)
    return ctypes.CDLL(str(out))


def ablate(*, T: int = 200, device: str | torch.device = "cuda") -> dict[str, dict[str, float]]:
    """µs per sample step of each variant as P2 and, where timed, P3; best
    of 3 after one warm call, timed by CUDA events."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the ablation times kernels: it needs a CUDA device")
    for name in VARIANTS:  # fail on a stale edit before building anything
        variant_source(name)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(_library, VARIANTS)))
    w = pb.prepare(pb.weights(), dev)
    dil, _ = _common.geometry(pb.L)
    out = {}
    for name, lib in libs.items():
        out[name] = {}
        for probe, persistent in (("P2", True), ("P3", False)):
            if probe == "P3" and not VARIANTS[name][1]:
                continue

            def run(persistent=persistent, lib=lib):
                return pb.launch(w, persistent=persistent, bias=True,
                                 cond_rule="step" if persistent else "layer",
                                 scaled_skip=False, row_out=False, head=False, B=pb.B,
                                 T=T, dil=dil, what=f"ablate {name}", lib=lib)[0]
            _, best = _common.time_best(run, dev)
            out[name][probe] = best / T * 1e6
        print(f"ablate {name:10s}: " + ", ".join(
            f"{k} {us:8.2f} us/step ({us / pb.L:6.2f} us/layer)" for k, us in out[name].items()),
            flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}, B={pb.B}, T={args.T}", flush=True)
    ablate(T=args.T, device=dev)


if __name__ == "__main__":
    main()
