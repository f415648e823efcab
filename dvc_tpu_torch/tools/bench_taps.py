"""P1, the port of tools/bench_taps.py: dynamic against static ring-buffer
reads inside a serial recurrence, each of L layers h = tanh((x_{t-d} +
x_{t-2d} + h) @ w), the layer input written into the ring.

  taps        the wrapper: a CUDA tensor launches csrc/bench_taps.cu (one
              cooperative launch, see there) or raises; a CPU tensor runs
              taps_plain.  ``taps.launches`` counts kernel launches by mode;
  taps_plain  the same float32 arithmetic and ring in PyTorch;
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


def default_w(r: int = R) -> np.ndarray:
    """The probe's weight, drawn as tools/bench_taps.py:71 draws it."""
    return np.asarray(np.random.RandomState(0).randn(r, r) * 0.01, np.float32)


def ring_slots(dil: np.ndarray) -> int:
    """Slots the ring needs: the dynamic segments (sum of 2d) or the static
    pairs (2L), whichever is longer (the probe's BUF = 504 covers both)."""
    return max(int(2 * dil.sum()), 2 * len(dil))


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
            [_common.VP] * 5
        lib.dvc_probe_taps.restype = _common.I32
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
    w_ptr = _common.cuda_checked(w, "w", dev, torch.float32)
    ring = torch.empty(slots, B, r, device=dev)
    h = torch.empty(2, B, r, device=dev)
    out = torch.empty(1, B, r, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dvc_probe_taps(MODES.index(mode), B, r, T, len(dil), dil.ctypes.data, slots,
                                 w_ptr, ring.data_ptr(), h.data_ptr(), out.data_ptr(), stream)
    _common.check(lib, err, f"bench_taps {mode}", "dvc_probe_taps_error_string")
    taps.launches[mode] += 1
    return out


taps.launches = collections.Counter()


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
