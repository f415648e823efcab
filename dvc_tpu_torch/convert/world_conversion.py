"""WORLD-feature voice conversion (port of dvc_tpu/convert/world_conversion.py).

The reference ships the WORLD machinery (preprocessing/WORLD_processing.py:
analysis, mcep transforms, log-Gaussian pitch conversion, synthesis) and an
MCC dataset/VAE path (SpeechDatasetMCC2, samples_length 128) but wires no
conversion entry point to them; dvc_tpu's conversion, ported here:

  1. the VAE latent swap on 128-frame chunks of normalized MCCs
     (chunking_mcc, model/variational_base_vae.py:350-360), one pass on the
     model's device;
  2. de-normalization by the target speaker's mcep statistics;
  3. mc2sp back to a spectral envelope (pysptk's math), on the device;
  4. the log-Gaussian pitch conversion src -> trg (WORLD_processing.py:
     187-192);
  5. WORLD synthesis: the native engine per utterance
     (``world_convert_utterance``), or the batched device synthesis over a
     corpus (``world_convert_corpus``).
"""

from __future__ import annotations

import numpy as np
import torch

from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.ops.chunk import chunk_mel, unchunk_mel
from dvc_tpu_torch.ops.world import (cheaptrick_fft_size, mc2sp, mcepalpha, pitch_conversion,
                                     synthesize_batch, world_speech_synthesis)


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def convert_mcc(model: DisentangledVAE, src_norm_mc: np.ndarray, trg_norm_mc: np.ndarray,
                frames: int = 128, fs_mask: np.ndarray | None = None) -> np.ndarray:
    """The latent swap in normalized-MCC space: (n_mcep, T) source and
    target -> converted normalized MCCs (n_mcep, chunks * frames), decoded
    without the postnet or a clamp.

    fs_mask: an optional (latent_dim,) binary mask (binarize_fs_mask): the
    FeatureSelection-masked swap takes the target's mean full latent on the
    masked dims and the source's per-chunk latent elsewhere."""
    dev = _model_device(model)
    src_chunks = chunk_mel(torch.as_tensor(np.asarray(src_norm_mc, np.float32), device=dev),
                           frames)
    trg_chunks = chunk_mel(torch.as_tensor(np.asarray(trg_norm_mc, np.float32), device=dev),
                           frames)
    src_style_mu, _, src_content_mu, _ = model.encode(src_chunks)
    trg_style_mu, _, trg_content_mu, _ = model.encode(trg_chunks)
    n = src_chunks.shape[0]
    if fs_mask is None:
        trg_style = trg_style_mu.mean(0, keepdim=True).expand(n, -1)
        z = torch.cat([trg_style, src_content_mu], -1)
    else:
        mask = torch.as_tensor(np.asarray(fs_mask, np.float32), device=dev)
        src_z = torch.cat([src_style_mu, src_content_mu], -1)
        trg_mean = torch.cat([trg_style_mu, trg_content_mu], -1).mean(0, keepdim=True)
        z = src_z * (1.0 - mask) + trg_mean * mask
    return unchunk_mel(model.decode(z)).cpu().numpy()


def _convert_features(model: DisentangledVAE, src_npz: dict, trg_npz: dict, trg_stats: dict,
                      src_logf0_stats: dict, trg_logf0_stats: dict, fs: int, frames: int,
                      fs_mask: np.ndarray | None = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Steps 1-4 (latent swap, de-normalization, mc2sp, pitch transform):
    (f0_conv, sp, ap) ready for synthesis."""
    src_f0 = np.asarray(src_npz["f0"])
    src_norm = np.asarray(src_npz["normalized_mc"]).T  # (n_mcep, T)
    trg_norm = np.asarray(trg_npz["normalized_mc"]).T  # (n_mcep, T')
    t = src_norm.shape[1]

    # 1-2. the latent swap (target style, source content), then the
    # target's de-normalization
    conv_norm = convert_mcc(model, src_norm, trg_norm, frames, fs_mask=fs_mask)[:, :t]
    mc = conv_norm.T * np.asarray(trg_stats["std"]).T + np.asarray(trg_stats["mean"]).T

    # 3. the envelope of the converted mel-cepstra, on the model's device
    with torch.inference_mode():
        sp = mc2sp(torch.as_tensor(mc.astype(np.float32), device=_model_device(model)),
                   mcepalpha(fs), cheaptrick_fft_size(fs)).cpu().numpy()

    # 4. the pitch conversion on voiced frames (unvoiced stay 0)
    voiced = src_f0 > 0
    f0_conv = np.zeros_like(src_f0)
    if voiced.any():
        f0_conv[voiced] = pitch_conversion(src_f0[voiced], src_logf0_stats["mean"],
                                           src_logf0_stats["std"], trg_logf0_stats["mean"],
                                           trg_logf0_stats["std"])

    # aperiodicity: flat for the converted speech
    ap = np.full((t, sp.shape[1]), 0.2, np.float32)
    ap[~voiced[:t]] = 1.0 - 1e-12
    return f0_conv[:t], sp[:t], ap


def _peak_normalize(wav: np.ndarray) -> np.ndarray:
    wav = np.asarray(wav)
    peak = np.abs(wav).max()
    return wav / peak * 0.95 if peak > 1e-8 else wav


def world_convert_utterance(model: DisentangledVAE, src_npz: dict, trg_npz: dict,
                            trg_stats: dict, src_logf0_stats: dict, trg_logf0_stats: dict,
                            fs: int = 16_000, frame_period: float = 5.0, frames: int = 128,
                            fs_mask: np.ndarray | None = None) -> np.ndarray:
    """One utterance through the WORLD route, synthesized by the native
    engine.  src_npz/trg_npz hold f0 and normalized_mc (T, n_mcep), the
    data/world_preprocess.py contract; the target utterance gives the style
    latent (target style, source content); trg_stats {"mean", "std"} are
    the target speaker's mcep statistics ((n_mcep, 1) as stored);
    *_logf0_stats {"mean", "std"} scalars."""
    f0_conv, sp, ap = _convert_features(model, src_npz, trg_npz, trg_stats, src_logf0_stats,
                                        trg_logf0_stats, fs, frames, fs_mask=fs_mask)
    return _peak_normalize(world_speech_synthesis(f0_conv, sp, ap, fs, frame_period))


def world_convert_corpus(model: DisentangledVAE, src_npzs: list, trg_npzs: list,
                         trg_stats: dict, src_logf0_stats: dict, trg_logf0_stats: dict,
                         fs: int = 16_000, frame_period: float = 5.0, frames: int = 128,
                         fs_mask: np.ndarray | None = None) -> list:
    """world_convert_utterance over a corpus, synthesized together on the
    model's device: steps 1-4 per utterance (the same numbers), then every
    waveform through synthesize_batch's buckets.  src_npzs[i] converts
    against trg_npzs[i]."""
    feats = [_convert_features(model, s, t, trg_stats, src_logf0_stats, trg_logf0_stats, fs,
                               frames, fs_mask=fs_mask)
             for s, t in zip(src_npzs, trg_npzs)]
    wavs = synthesize_batch([f[0] for f in feats], [f[1] for f in feats],
                            [f[2] for f in feats], fs, frame_period,
                            device=_model_device(model))
    return [_peak_normalize(w) for w in wavs]
