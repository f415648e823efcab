"""P1, the port of tools/bench_taps.py: dynamic against static ring-buffer
reads inside a serial recurrence, each of L layers h = tanh((x_{t-d} +
x_{t-2d} + h) @ w), the layer input written into the ring.

  taps        the wrapper: a CUDA tensor launches csrc/bench_taps.cu (one
              cluster launch, a cluster of CTAs per batch row, see there)
              or raises; a CPU tensor runs taps_plain.  ``taps.launches``
              counts kernel launches by mode;
  taps_plain  the same float32 arithmetic and ring in PyTorch;
  cluster_plan  the kernel's plan (cluster size, channels and shared memory
              a CTA), as the .cu file computes it;
  make        the probe at its constants (B=8, R=512, T=2000, 24 layers);
  bench       one warm call, the best of 3, printed as the JAX probe does.

    python -m dvc_tpu_torch.tools.bench_taps [--device cuda|cpu] [--T N]
"""

from __future__ import annotations

import argparse
import collections
import ctypes

import numpy as np
import torch

from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.tools import _common
from dvc_tpu_torch.utils.device import resolve_device

MODES = ("dynamic", "static", "compute")
B, R, T, LAYERS = 8, 512, 2000, 24
# csrc/bench_taps.cu's constants (held to the source by the tests)
CLUSTER, COLS, THREADS, MAX_SMEM = 8, 64, 512, 232448


def default_w(r: int = R) -> np.ndarray:
    """The probe's weight, drawn as tools/bench_taps.py:71 draws it."""
    return np.asarray(np.random.RandomState(0).randn(r, r) * 0.01, np.float32)


def ring_slots(dil: np.ndarray) -> int:
    """Slots the ring needs: the dynamic segments (sum of 2d) or the static
    pairs (2L), whichever is longer (the probe's BUF = 504 covers both)."""
    return max(int(2 * dil.sum()), 2 * len(dil))


def cluster_plan(r: int, slots: int, mode: str = "dynamic") -> dict[str, int]:
    """What one batch row's cluster of the kernel holds: CLUSTER CTAs of
    THREADS threads, each owning COLS channels of h and the ring and those
    columns of w (kept in registers, w_regs a thread), its ring slice,
    u's two buffers, two buffers of partial sums and their two mbarriers in
    shared memory (smem_bytes; compute mode has no ring).  Raises
    ValueError for a plan the kernel refuses."""
    if r != CLUSTER * COLS:
        raise ValueError(f"the cluster plan takes R = {CLUSTER} x {COLS} = {CLUSTER * COLS} "
                         f"channels, got R = {r}")
    ring = 0 if mode == "compute" else slots
    slices = THREADS // COLS
    smem = (ring * COLS + 2 * r + 2 * slices * COLS) * 4 + 16  # and two mbarriers
    if smem > MAX_SMEM:
        raise ValueError(f"a ring of {slots} slots needs {smem} bytes of shared memory a CTA, "
                         f"over the {MAX_SMEM} a block can have")
    return {"cluster": CLUSTER, "cols": COLS, "threads": THREADS, "w_regs": r // slices,
            "ring_bytes": ring * COLS * 4, "smem_bytes": smem}


@torch.no_grad()
def taps_plain(mode: str, w: torch.Tensor, *, B: int, T: int, dil) -> torch.Tensor:
    """The kernel's function in PyTorch: (1, B, R) float32, the final h."""
    dil = _common.dil_array(dil)
    offs = _common.offsets(dil)
    r = w.shape[0]
    ring = torch.zeros(ring_slots(dil), B, r, device=w.device)
    h = torch.ones(B, r, device=w.device)
    for t in range(T):
        for li in range(len(dil)):
            if mode == "compute":
                u = h + h + h
            else:
                if mode == "dynamic":
                    s2, s1 = _common.taps_of(t, int(dil[li]), int(offs[li]))
                else:
                    s2, s1 = 2 * li, 2 * li + 1
                u = ring[s1] + ring[s2] + h
                ring[s2] = h
            h = torch.tanh(u @ w)
    return h[None]


def _lib():
    lib = _build.load("bench_taps")
    if not getattr(lib, "_dvc_typed", False):
        lib.dvc_probe_taps.argtypes = [_common.I32] * 5 + [_common.VP, _common.I32] + \
            [_common.VP] * 3
        lib.dvc_probe_taps.restype = _common.I32
        lib.dvc_probe_taps_plan.argtypes = [_common.I32, _common.I32, _common.VP]
        lib.dvc_probe_taps_plan.restype = _common.I32
        lib.dvc_probe_taps_error_string.argtypes = [_common.I32]
        lib.dvc_probe_taps_error_string.restype = ctypes.c_char_p
        lib._dvc_typed = True
    return lib


def taps(mode: str, w: torch.Tensor, *, B: int, T: int, dil) -> torch.Tensor:
    """P1 over T steps: (1, B, R) float32, the final h.  w (R, R) float32,
    (in, out); dil the L layers' dilations.  On a CUDA tensor this launches
    the kernel or raises; on a CPU tensor it runs taps_plain."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if w.dim() != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"w must be (R, R), got {tuple(w.shape)}")
    if B < 1 or T < 0:
        raise ValueError(f"need B >= 1 and T >= 0, got B={B}, T={T}")
    dil = _common.dil_array(dil)
    if w.device.type == "cpu":
        return taps_plain(mode, w, B=B, T=T, dil=dil)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    dev, r, slots = w.device, w.shape[0], ring_slots(dil)
    cluster_plan(r, slots, mode)
    w_ptr = _common.cuda_checked(w, "w", dev, torch.float32)
    out = torch.empty(1, B, r, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dvc_probe_taps(MODES.index(mode), B, r, T, len(dil), dil.ctypes.data, slots,
                                 w_ptr, out.data_ptr(), stream)
    _common.check(lib, err, f"bench_taps {mode}", "dvc_probe_taps_error_string")
    taps.launches[mode] += 1
    return out


taps.launches = collections.Counter()


def device_plan(r: int, slots: int, device: str | torch.device = "cuda") -> dict[str, int]:
    """The kernel's own plan on the card, as cluster_plan's keys plus
    max_active_clusters (cudaOccupancyMaxActiveClusters): clusters, so batch
    rows, that run at once."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the device plan is the card's: it needs a CUDA device")
    lib = _lib()
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        err = lib.dvc_probe_taps_plan(r, slots, ctypes.addressof(plan))
    _common.check(lib, err, "bench_taps plan", "dvc_probe_taps_error_string")
    return dict(zip(("cluster", "cols", "threads", "smem_bytes", "max_active_clusters"), plan))


def make(mode: str, w=None, *, B: int = B, R: int = R, T: int = T, layers: int = LAYERS,
         device: str | torch.device = "cuda"):
    """The probe's callable: f() -> (1, B, R), as tools/bench_taps.make(mode)
    returns.  w defaults to default_w(R); cuda without a card raises."""
    dev = resolve_device(device)
    w = default_w(R) if w is None else w
    w_t = torch.as_tensor(w, dtype=torch.float32).to(dev).contiguous()
    dil, _ = _common.geometry(layers)
    return lambda: taps(mode, w_t, B=B, T=T, dil=dil)


def bench(mode: str, *, B: int = B, R: int = R, T: int = T, layers: int = LAYERS,
          device: str | torch.device = "cuda") -> dict:
    """One warm call, then the best of 3 (CUDA events on a card), printed as
    the JAX probe prints it; returns the numbers."""
    dev = resolve_device(device)
    _, best = _common.time_best(make(mode, B=B, R=R, T=T, layers=layers, device=dev), dev)
    per_iter = best / T * 1e6
    print(f"{mode:8s}: {best * 1e3:8.2f} ms total, {per_iter:7.3f} us/iter, "
          f"{per_iter / layers * 1000:7.1f} ns/layer", flush=True)
    return {"mode": mode, "ms": best * 1e3, "us_per_step": per_iter,
            "ns_per_layer": per_iter / layers * 1000}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=T)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}", flush=True)
    for mode in ("compute", "static", "dynamic"):
        bench(mode, T=args.T, device=dev)


if __name__ == "__main__":
    main()
