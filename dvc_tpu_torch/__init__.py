"""dvc_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of dvc_tpu.

A second package beside the JAX one, with the same layout and module names so
each module's counterpart is easy to find.  It imports torch, numpy and the
standard library only — never jax, flax or anything under dvc_tpu — and keeps
its own copies of what it needs.

Ported so far: the serving path (HTTP wav at any sample rate -> mel ->
64-frame chunks -> DisentangledVAE latent swap, or the model-free profile
transfer -> Griffin-Lim or the WaveNet vocoder, whose autoregressive
mixture-of-logistics sampler runs in a hand-written CUDA kernel,
kernels/csrc/wavenet_step.cu) and the VAE's training path (paired mel
dataset -> pairwise forward with grouped BatchNorm -> group-VAE loss ->
Adam -> .pth checkpoints).

Layers:
  ops/       STFT, mel, chunking, resampling (torch tensors, any device)
  data/      the paired-utterance dataset (numpy)
  models/    nn.Modules with the reference checkpoints' state-dict names
  kernels/   hand-written CUDA kernels, their ctypes bindings and plain twins
  convert/   latent-swap conversion, Griffin-Lim and the WaveNet vocoder
  train/     losses, the trainer, checkpoint save/discovery/resume
  utils/     wav IO, the JAX-tree -> state-dict weight bridge, device rules
  serve.py   micro-batching HTTP conversion services
  cli/       python -m dvc_tpu_torch.cli.run {train,serve,convert,vocode}
"""

__version__ = "0.1.0"
