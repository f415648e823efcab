"""dvc_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of dvc_tpu.

A second package beside the JAX one, with the same layout and module names so
each module's counterpart is easy to find.  It imports torch, numpy and the
standard library only — never jax, flax or anything under dvc_tpu — and keeps
its own copies of what it needs.

This slice ports the serving path: HTTP wav -> mel -> 64-frame chunks ->
DisentangledVAE latent swap -> WaveNet vocoder, whose autoregressive
mixture-of-logistics sampler runs in a hand-written CUDA kernel
(kernels/csrc/wavenet_step.cu).

Layers:
  ops/       STFT, mel, chunking (torch tensors, any device)
  models/    nn.Modules with the reference checkpoints' state-dict names
  kernels/   hand-written CUDA kernels, their ctypes bindings and plain twins
  convert/   latent-swap conversion and the vocoder
  train/     checkpoint discovery (load side)
  utils/     wav IO, the JAX-tree -> state-dict weight bridge, device rules
  serve.py   micro-batching HTTP conversion service
  cli/       python -m dvc_tpu_torch.cli.run {serve,convert,vocode}
"""

__version__ = "0.1.0"
