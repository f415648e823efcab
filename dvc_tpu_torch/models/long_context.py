"""Whole-utterance (long-context) encoding for the DisentangledVAE (port of
dvc_tpu/models/long_context.py).

The reference converts an utterance as INDEPENDENT 64-frame chunks, so the
encoder's receptive field (three k=5 convs and a 2-layer biLSTM) stops at
every chunk boundary.  Here the conv stack (BatchNorm on its running
statistics) and the biLSTM run ONCE over the whole utterance, and the
linear, style and content heads, whose 8192-wide input fixes 64 frames,
are applied to each 64-frame slice of that output: no new parameters, any
checkpoint works.  ``convert_mel_long_context`` drops the per-chunk
latents into the usual conversion (style = mean over chunks, decode per
chunk).  With a ``mesh`` (parallel.mesh.make_mesh) the frame axis is
sharded over its data axis: halo-exchange convolutions and the
carry-relay LSTM of parallel/sequence.py, then the LSTM output gathered
for the heads, so every rank of the mesh returns the whole result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dvc_tpu_torch.config import VAEConfig
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.parallel.collectives import gather_blocks
from dvc_tpu_torch.parallel.mesh import data_rows
from dvc_tpu_torch.parallel.sequence import (frame_sharded_encode_conv_stack,
                                             sequence_sharded_lstm)


@torch.inference_mode()
def whole_utterance_encode(cfg: VAEConfig, model: DisentangledVAE, mel, mesh=None):
    """Full-context encode of (B, n_mels, T) mels, T zero-padded up to the
    next multiple of ``cfg.frames``.  Returns the per-chunk posteriors
    (style_mu, style_logvar, content_mu, content_logvar), each
    (B, n_chunks, dim).  At T == cfg.frames this is ``model.encode`` in eval
    mode.

    An exact multiple of ``cfg.frames`` gets exactly T / frames chunks:
    unlike chunk_mel there is no all-zero last chunk, which would feed fake
    context into the real chunks through the biLSTM (dvc_tpu's deliberate
    deviation, long_context.py:121-131).

    With a ``mesh`` every rank of it calls this with the same ``mel``; the
    padded frame count must divide the mesh's size, as in dvc_tpu."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(mel, dtype=torch.float32, device=dev)
    t = x.shape[-1]
    n_chunks = -(-t // cfg.frames)
    x = F.pad(x, (0, n_chunks * cfg.frames - t))
    if mesh is None:
        for m in model.enc_modules:
            conv, bn = m[0], m[1]
            x = F.relu(F.batch_norm(conv(x), bn.running_mean, bn.running_var, bn.weight,
                                    bn.bias, training=False, eps=bn.eps))
        h, _ = model.enc_lstm(x.transpose(1, 2))  # (B, T, 2 * dim_neck)
    else:
        h = _frame_sharded_encode(model, x, mesh)
    # each chunk's slice in (T, W) row-major order, as encode flattens it
    flat = h.reshape(h.shape[0], n_chunks, -1)
    z = F.relu(model.enc_linear(flat))
    style, content = model.style(z), model.content(z)
    s, k = cfg.speaker_size, cfg.content_size
    return style[..., :s], style[..., s:], content[..., :k], content[..., k:]


def _frame_sharded_encode(model: DisentangledVAE, x: torch.Tensor, mesh) -> torch.Tensor:
    """The conv stack and biLSTM of ``model`` over x (B, n_mels, T) with the
    frame axis sharded over the mesh's data axis; returns the whole LSTM
    output (B, T, 2 * dim_neck) on every rank."""
    n_dev = mesh.dp * mesh.mp
    if x.shape[-1] % n_dev:
        raise ValueError(f"padded frame count {x.shape[-1]} must divide the {n_dev}-device "
                         "mesh; pick an utterance length or mesh size accordingly")
    h = frame_sharded_encode_conv_stack(x[..., data_rows(x.shape[-1], mesh)], model, mesh)
    h = h.transpose(1, 2)  # (B, T_local, C)
    lstm = model.enc_lstm
    for layer in range(lstm.num_layers):
        outs = []
        for sfx, rev in (("", False), ("_reverse", True)):
            w = [getattr(lstm, f"{k}_l{layer}{sfx}")
                 for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            outs.append(sequence_sharded_lstm(h, *w, mesh, reverse=rev)[0])
        h = torch.cat(outs, -1)
    return gather_blocks(h, 1, mesh.data_group)


def convert_mel_long_context(model: DisentangledVAE, source_mel: np.ndarray,
                             target_mel: np.ndarray, frames: int = 64, mesh=None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """convert/conversion.convert_mel with whole-utterance encoding: the same
    latent swap, the posteriors from whole_utterance_encode.  (80, Ts),
    (80, Tt) -> (recons, converted), both (80, ceil(Ts / 64) * 64); only the
    conversion is clipped to [0, 1]."""
    from dvc_tpu_torch.convert.conversion import swap_decode
    cfg = model.cfg
    if frames != cfg.frames:
        raise ValueError(f"frames={frames} does not match the model's "
                         f"architectural chunk size cfg.frames={cfg.frames}")
    src_style_mu, _, src_content_mu, _ = (
        a[0] for a in whole_utterance_encode(cfg, model, np.asarray(source_mel)[None], mesh))
    trg_style_mu, _, trg_content_mu, _ = (
        a[0] for a in whole_utterance_encode(cfg, model, np.asarray(target_mel)[None], mesh))
    recons, converted = swap_decode(model, src_style_mu, src_content_mu, trg_style_mu,
                                    trg_content_mu)
    return recons.cpu().numpy(), converted.cpu().numpy()
