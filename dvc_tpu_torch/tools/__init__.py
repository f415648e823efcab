"""The ports of the repository's tools/ Pallas probes: microbenchmarks of the
WaveNet layer body, each a hand-written CUDA kernel for Hopper beside a plain
PyTorch twin and a launch count.

  bench_taps   P1, tools/bench_taps.py: ring taps in a serial recurrence
               (modes dynamic, static, compute), a cluster of CTAs a row;
  bench_body   P2 and P3, tools/bench_body.py: the 6-matmul body with all
               weights "resident" (one persistent launch on the tensor
               cores, a grid barrier between dependent phases) and streamed
               over a (T, L) grid (two launches a layer, chained by
               programmatic dependent launch, a step's CUDA graph replayed);
  bench_body2  P4, tools/bench_body2.py: the resident body with production
               features added stage by stage (0-4);
  ablate_body  P2 and P3 timed with parts of their kernels cut out, to show
               where a layer's time goes (no counterpart in tools/);
  bench_sync   the card's cluster and grid barriers and a kernel launch
               (stream, graph, programmatic dependent launch) timed alone
               (no counterpart in tools/).

Each runs as ``python -m dvc_tpu_torch.tools.<probe>`` on cuda and prints
what the JAX probe prints; ``make(..., device="cpu")`` runs the plain twin.
Nothing is built at import: the first CUDA launch builds the kernel.
"""
