"""The price of Hopper's exchange primitives and of a kernel launch on the
card, which the probe kernels' designs choose between (csrc/bench_sync.cu):

  occupancy  cudaOccupancyMaxActiveClusters for clusters of 2-16 CTAs of
             BIG_SMEM bytes each (one CTA an SM, as the probe kernels run);
  cluster    us per cluster.sync() at each cluster size (CLUSTERS_AT_ONCE
             clusters, fewer than run at once at 16);
  counter    us per grid barrier of body_mma's kind (a release/acquire
             arrival count) over BLOCKS blocks;
  grid       us per cooperative_groups grid sync over BLOCKS blocks;
  launch     us a launch of a chain of CHAIN empty dependent kernels of
             128 and 132 blocks (LAUNCH_BLOCKS), four ways (LAUNCH_MODES):
             one by one into a stream, the same with programmatic dependent
             launch (PDL), a CUDA graph of the chain, and the graph with
             programmatic edges (P3's way, csrc/probe_body.cu); the graph is
             instantiated before the timing.

    python -m dvc_tpu_torch.tools.bench_sync

Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from dvc_tpu_torch.kernels import _build
from dvc_tpu_torch.tools import _common
from dvc_tpu_torch.utils.device import resolve_device

CLUSTERS = (2, 4, 8, 16)
CLUSTERS_AT_ONCE = 4
BIG_SMEM = 140_000
BLOCKS = 128
KINDS = ("cluster", "counter", "grid")  # in the order of the kernel's codes 0, 1, 2
LAUNCH_MODES = ("stream", "stream_pdl", "graph", "graph_pdl")  # codes 0-3
LAUNCH_BLOCKS = (128, 132)  # the probe kernels' grid, and one block an SM of an H100
CHAIN = 960  # launches a chain: 20 of P3's steps of 48


def _lib() -> ctypes.CDLL:
    lib = _build.load("bench_sync")
    if not getattr(lib, "_dvc_typed", False):
        i32, vp = _common.I32, _common.VP
        lib.dvc_sync_cluster_occupancy.argtypes = [i32, i32, vp]
        lib.dvc_sync_cluster_occupancy.restype = i32
        lib.dvc_sync_loop.argtypes = [i32] * 5 + [vp, vp]
        lib.dvc_sync_loop.restype = i32
        lib.dvc_sync_launch_chain.argtypes = [i32] * 4 + [vp, vp]
        lib.dvc_sync_launch_chain.restype = i32
        lib.dvc_sync_error_string.argtypes = [i32]
        lib.dvc_sync_error_string.restype = ctypes.c_char_p
        lib._dvc_typed = True
    return lib


def occupancy(cluster: int, device: torch.device, smem: int = BIG_SMEM) -> int:
    """Clusters of ``cluster`` CTAs that run at once on the card."""
    lib, out = _lib(), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.dvc_sync_cluster_occupancy(cluster, smem, ctypes.addressof(out))
    _common.check(lib, err, f"cluster occupancy at {cluster}", "dvc_sync_error_string")
    return out.value


def per_barrier_us(kind: str, device: torch.device, *, blocks: int, cluster: int = 1,
                   smem: int = BIG_SMEM, iters: int = 20_000) -> float:
    """us per barrier of one launch of ``iters`` barriers, after a warm
    launch, timed between CUDA events."""
    lib = _lib()
    count = torch.zeros(4, dtype=torch.int32, device=device)

    def launch(n):
        err = lib.dvc_sync_loop(KINDS.index(kind), blocks, cluster, smem, n, count.data_ptr(),
                                torch.cuda.current_stream(device).cuda_stream)
        _common.check(lib, err, f"{kind} barriers", "dvc_sync_error_string")

    with torch.cuda.device(device):
        launch(iters // 10)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(iters)
        end.record()
        torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e3 / iters


def per_launch_us(mode: str, device: torch.device, *, blocks: int, n: int = CHAIN,
                  reps: int = 5) -> float:
    """us a launch of a chain of ``n`` empty dependent kernels launched the
    ``mode`` way, timed by the library between two CUDA events over
    ``reps`` rounds after a warm one."""
    lib, us = _lib(), ctypes.c_double(0.0)
    with torch.cuda.device(device):
        err = lib.dvc_sync_launch_chain(LAUNCH_MODES.index(mode), blocks, n, reps,
                                        torch.cuda.current_stream(device).cuda_stream,
                                        ctypes.addressof(us))
    _common.check(lib, err, f"{mode} launch chain", "dvc_sync_error_string")
    return us.value


def measure(device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the barriers are the card's: it needs a CUDA device")
    return {"occupancy": {c: occupancy(c, dev) for c in CLUSTERS},
            "cluster_us": {c: per_barrier_us("cluster", dev, blocks=c * CLUSTERS_AT_ONCE,
                                             cluster=c) for c in CLUSTERS},
            "counter_us": per_barrier_us("counter", dev, blocks=BLOCKS),
            "grid_us": per_barrier_us("grid", dev, blocks=BLOCKS),
            "launch_us": {m: {b: per_launch_us(m, dev, blocks=b) for b in LAUNCH_BLOCKS}
                          for m in LAUNCH_MODES}}


def report(m: dict) -> str:
    return (f"clusters at once (one CTA an SM): "
            + ", ".join(f"{c}: {n}" for c, n in m["occupancy"].items())
            + "; us a cluster barrier: "
            + ", ".join(f"{c}: {us:.3f}" for c, us in m["cluster_us"].items())
            + f"; us a grid barrier over {BLOCKS} blocks: counter {m['counter_us']:.3f}, "
            f"cooperative_groups {m['grid_us']:.3f}; us a launch of {CHAIN} empty dependent "
            f"kernels of " + "/".join(map(str, LAUNCH_BLOCKS)) + " blocks: "
            + ", ".join(f"{mode} " + "/".join(f"{us:.3f}" for us in by_b.values())
                        for mode, by_b in m["launch_us"].items()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}", flush=True)
    print(report(measure(dev)), flush=True)


if __name__ == "__main__":
    main()
