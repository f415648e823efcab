"""Latent-swap voice conversion (port of dvc_tpu/convert/conversion.py).

Reference voice_conversion_mel (model/variational_base_vae.py:243-330):
  1. chunk source/target mels into (N, 80, 64) blocks;
  2. encode both; per-speaker style = MEAN of style_mu over chunks;
  3. source_z  = [src_style, src_content_mu]   (reconstruction probe)
     convert_z = [trg_style, src_content_mu]   (the conversion);
  4. decode; converted += postnet(converted); clamp to [0, 1];
  5. concatenate chunks on time; vocode.
The chunk axis is the batch axis, so an utterance converts in one pass.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob

import numpy as np
import torch

from dvc_tpu_torch.config import Config
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.ops.chunk import chunk_mel, unchunk_mel
from dvc_tpu_torch.utils.wavio import write_wav


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def _convert_chunks(model: DisentangledVAE, src_chunks: torch.Tensor,
                    trg_chunks: torch.Tensor, mask: torch.Tensor | None = None):
    """(Ns, 80, F), (Nt, 80, F) -> (recons, converted), both (80, Ns*F).

    mask None: the plain swap of the first speaker_size style dims.
    mask (D,) in {0, 1}: the FeatureSelection-masked swap — convert_z takes
    the target's mean FULL latent on masked dims and the source's latent
    elsewhere (conversion.py:58-95)."""
    src_style_mu, _, src_content_mu, _ = model.encode(src_chunks)
    trg_style_mu, _, trg_content_mu, _ = model.encode(trg_chunks)
    return swap_decode(model, src_style_mu, src_content_mu, trg_style_mu,
                       trg_content_mu, mask)


@torch.inference_mode()
def swap_decode(model: DisentangledVAE, src_style_mu: torch.Tensor,
                src_content_mu: torch.Tensor, trg_style_mu: torch.Tensor,
                trg_content_mu: torch.Tensor, mask: torch.Tensor | None = None):
    """Per-chunk posterior means -> (recons, converted), both (80, Ns*F):
    the latent swap (style = mean over chunks), decode, the postnet on the
    conversion, clamped to [0, 1], and the chunks joined on time."""
    n = src_content_mu.shape[0]
    src_style = src_style_mu.mean(0, keepdim=True).expand(n, -1)
    source_z = torch.cat([src_style, src_content_mu], -1)
    if mask is None:
        trg_style = trg_style_mu.mean(0, keepdim=True).expand(n, -1)
        convert_z = torch.cat([trg_style, src_content_mu], -1)
    else:
        trg_mean = torch.cat([trg_style_mu, trg_content_mu], -1).mean(0, keepdim=True)
        convert_z = source_z * (1.0 - mask) + trg_mean * mask
    recons = model.decode(source_z)
    converted = model.decode(convert_z)
    converted = converted + model.postnet(converted)
    return unchunk_mel(recons), unchunk_mel(torch.clamp(converted, 0.0, 1.0))


def binarize_fs_mask(mask: np.ndarray, speaker_size: int, threshold: float = 0.5,
                     top_k: int | None = None) -> np.ndarray:
    """Sigmoid feature mask (train-fs output) -> binary swap mask (D,).

    Dims above threshold are swapped; the first speaker_size style dims
    always are.  top_k caps the number of CONTENT dims swapped (the k
    highest-sigmoid ones above threshold)."""
    raw = np.asarray(mask, np.float32)
    m = (raw > threshold).astype(np.float32)
    if top_k is not None:
        content = raw[speaker_size:].copy()
        m[speaker_size:] = 0.0
        for i in np.argsort(content)[::-1][:max(0, top_k)]:
            if content[i] > threshold:
                m[speaker_size + i] = 1.0
    m[:speaker_size] = 1.0
    return m


def convert_mel(model: DisentangledVAE, source_mel: np.ndarray, target_mel: np.ndarray,
                frames: int = 64, fs_mask: np.ndarray | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """(80, Ts), (80, Tt) -> (recons, converted), both (80, (Ts//64+1)*64),
    on the model's device.  fs_mask: optional (latent_dim,) binary mask for
    the FeatureSelection-masked swap.  Like the reference, the zero-padded
    tail of the last chunk is kept."""
    dev = _model_device(model)
    src = chunk_mel(torch.as_tensor(np.asarray(source_mel, np.float32), device=dev), frames)
    trg = chunk_mel(torch.as_tensor(np.asarray(target_mel, np.float32), device=dev), frames)
    mask = None if fs_mask is None else torch.as_tensor(
        np.asarray(fs_mask, np.float32), device=dev)
    recons, converted = _convert_chunks(model, src, trg, mask)
    return recons.cpu().numpy(), converted.cpu().numpy()


def profile_transfer_mel(source_mel: np.ndarray, src_profile: np.ndarray,
                         trg_profile: np.ndarray) -> np.ndarray:
    """DSP baseline: shift the source mel by the difference of time-averaged
    speaker profiles, clipped to [0, 1].  (80, T), (80,), (80,) -> (80, T)."""
    src = np.asarray(source_mel, np.float32)
    shift = (np.asarray(trg_profile, np.float32)
             - np.asarray(src_profile, np.float32))[:, None]
    return np.clip(src + shift, 0.0, 1.0)


def speaker_mel_profile(mel_fps, max_utterances: int = 32) -> np.ndarray:
    """Mean spectral profile (80,) of a speaker: the time-mean mel averaged
    over up to ``max_utterances`` of the speaker's .npy files, the statistic
    profile_transfer_mel shifts between."""
    profs = [np.asarray(np.load(fp), np.float32).mean(axis=1)
             for fp in list(mel_fps)[:max_utterances]]
    if not profs:
        raise FileNotFoundError("no mel .npy files to build a profile from")
    return np.mean(profs, axis=0)


def content_sensitivity(outputs, sources) -> float:
    """How much of the source's utterance-to-utterance variation survives a
    conversion (dvc_tpu/convert/conversion.py:183-204): mean|f(u0) - f(u1)|
    over mean|src_u0 - src_u1| for a pair of same-speaker utterances
    converted to one target, each pair cropped to its shorter length.
    1.0: content kept whole (profile_transfer_mel scores exactly 1 on
    mels); 0.0: the output ignores its source."""
    (o0, o1), (s0, s1) = outputs, sources
    o0, o1, s0, s1 = (np.asarray(x) for x in (o0, o1, s0, s1))
    t = min(o0.shape[-1], o1.shape[-1])
    ts = min(s0.shape[-1], s1.shape[-1])
    denom = float(np.mean(np.abs(s0[..., :ts] - s1[..., :ts])))
    return float(np.mean(np.abs(o0[..., :t] - o1[..., :t]))) / max(denom, 1e-9)


@dataclass
class VoiceConverter:
    """Directory-level runner mirroring voice_conversion_mel's file handling:
    the first ``num_utterances`` sorted source utterances, each with a random
    target utterance, written under a per-pair save dir.

    Target files are sorted before the random pick, so a seed picks the same
    target utterance on any filesystem (dvc_tpu globs them unsorted).
    ``profile_transfer`` is the model-free DSP conversion
    (profile_transfer_mel between the speakers' mean profiles; ``model`` may
    be None); ``long_context`` encodes each utterance whole
    (models/long_context.py) instead of as independent 64-frame chunks."""

    cfg: Config
    model: DisentangledVAE | None
    seed: int = 0
    long_context: bool = False
    fs_mask: np.ndarray | None = None
    profile_transfer: bool = False

    def convert_speaker_pair(self, dataset_fp: str, src_spk: str, trg_spk: str,
                             generation_dir: str, num_utterances: int = 2,
                             vocoder=None, save_png: bool = True):
        """Returns a list of (utterance_id, recons_mel, converted_mel[,
        waveform]) tuples; waveforms are also written as wavs, and with
        ``save_png`` four mel PNGs an utterance."""
        if self.long_context and self.fs_mask is not None:
            raise ValueError(
                "--fs_mask is not supported with --long_context "
                "(the whole-utterance encoder has its own latent "
                "assembly); drop one of the two flags")
        rng = np.random.RandomState(self.seed)
        save_dir = os.path.join(generation_dir, f"{src_spk}_to_{trg_spk}")
        os.makedirs(save_dir, exist_ok=True)

        src_fps = sorted(glob(os.path.join(dataset_fp, src_spk, "*.npy")))
        trg_fps = sorted(glob(os.path.join(dataset_fp, trg_spk, "*.npy")))
        if not src_fps:
            raise FileNotFoundError(
                f"no mel .npy files for source speaker {src_spk!r} under {dataset_fp}")
        if not trg_fps:
            raise FileNotFoundError(
                f"no mel .npy files for target speaker {trg_spk!r} under {dataset_fp}")
        if self.profile_transfer:
            if self.fs_mask is not None or self.long_context:
                raise ValueError(
                    "--profile_transfer is a model-free DSP conversion; it "
                    "cannot be combined with --fs_mask or --long_context")
            src_prof = speaker_mel_profile(src_fps)
            trg_prof = speaker_mel_profile(trg_fps)
        results = []
        for i in range(min(num_utterances, len(src_fps))):
            source_mel = np.load(src_fps[i])
            target_mel = np.load(trg_fps[rng.choice(len(trg_fps))])
            # "<spk>_<utt>_mel.npy" -> "<utt>" (reference naming)
            parts = os.path.basename(src_fps[i]).split(".")[0].split("_")
            utt_id = parts[-2] if len(parts) >= 2 else str(i)
            if self.profile_transfer:
                # recons slot = the source itself: there is no autoencoder
                recons = source_mel
                converted = profile_transfer_mel(source_mel, src_prof, trg_prof)
            elif self.long_context:
                from dvc_tpu_torch.models.long_context import convert_mel_long_context
                recons, converted = convert_mel_long_context(self.model, source_mel,
                                                             target_mel, self.cfg.vae.frames)
            else:
                recons, converted = convert_mel(self.model, source_mel, target_mel,
                                                self.cfg.vae.frames, fs_mask=self.fs_mask)
            if save_png:
                self._save_pngs(save_dir, src_spk, trg_spk, utt_id, source_mel, recons,
                                converted)
            results.append([utt_id, recons, converted])

        if vocoder is not None:
            mels = [r[2] for r in results]
            batch_fn = getattr(vocoder, "batch", None)
            wavs = batch_fn(mels) if batch_fn is not None else [vocoder(m) for m in mels]
            for entry, wav in zip(results, wavs):
                write_wav(os.path.join(
                    save_dir, f"convert_{src_spk}_to_{trg_spk}_{entry[0]}.wav"),
                    wav, self.cfg.audio.sample_rate)
                entry.append(wav)
        return [tuple(r) for r in results]

    @staticmethod
    def _save_pngs(save_dir, src_spk, trg_spk, utt_id, source, recons, converted):
        """dvc_tpu's four PNGs an utterance (conversion.py:306-327): the
        original, the conversion, the reconstruction and the spectral
        detail source * recons / converted."""
        from dvc_tpu_torch.utils.plotting import save_mel_png
        save_mel_png(source, os.path.join(save_dir, f"original_{src_spk}_{utt_id}.png"),
                     f"original_{src_spk}_{utt_id}")
        save_mel_png(converted, os.path.join(
            save_dir, f"convert_{src_spk}_{trg_spk}_{utt_id}.png"),
            f"convert_{src_spk}_{trg_spk}_{utt_id}")
        save_mel_png(recons, os.path.join(save_dir, f"recons_{src_spk}_{utt_id}.png"),
                     f"reconstruct_{src_spk}_{utt_id}")
        t = min(source.shape[1], recons.shape[1])
        detail = source[:, :t] * (recons[:, :t] / np.maximum(converted[:, :t], 1e-6))
        save_mel_png(detail, os.path.join(
            save_dir, f"spectral_detail_{src_spk}_{trg_spk}_{utt_id}.png"),
            f"spectral_detail_{src_spk}_{trg_spk}_{utt_id}")
