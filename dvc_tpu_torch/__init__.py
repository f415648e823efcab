"""dvc_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of dvc_tpu.

A second package beside the JAX one, with the same layout and module names so
each module's counterpart is easy to find.  It imports torch, numpy and the
standard library only — never jax, flax or anything under dvc_tpu — and keeps
its own copies of what it needs.

Ported so far: the verify recipe (preprocess: audio -> resample -> volume ->
VAD trim -> mel .npy files; train: paired mel dataset -> pairwise forward
with grouped BatchNorm -> group-VAE loss -> Adam -> dvc_tpu's .msgpack and
the reference's .pth checkpoints; convert; eval-mcd: WORLD analysis -> DTW
-> MCD) and the serving path (HTTP wav at any sample rate -> mel -> 64-frame
chunks -> DisentangledVAE latent swap, or the model-free profile transfer
-> Griffin-Lim or the WaveNet vocoder, whose autoregressive
mixture-of-logistics sampler runs in a hand-written CUDA kernel,
kernels/csrc/wavenet_step.cu).

Layers:
  ops/       STFT, mel, chunking, resampling, volume, VAD, CheapTrick and
             the mel-cepstrum (torch tensors, any device)
  data/      preprocessing and the paired-utterance dataset
  native/    the C++ engines (FLAC, mel/DTW, Harvest/D4C), built with g++
  eval/      mel-cepstral distortion
  models/    nn.Modules with the reference checkpoints' state-dict names
  kernels/   hand-written CUDA kernels, their ctypes bindings and plain twins
  convert/   latent-swap conversion, Griffin-Lim and the WaveNet vocoder
  train/     losses, the trainer, checkpoint save/discovery/resume
  utils/     audio IO, flax's msgpack format, the JAX-tree <-> state-dict
             weight bridge, device rules
  serve.py   micro-batching HTTP conversion services
  cli/       python -m dvc_tpu_torch.cli.run
             {preprocess,train,convert,eval-mcd,serve,vocode}
"""

__version__ = "0.1.0"
