"""Speaker-encoder inference: utterance embeddings from sliding partials
(port of dvc_tpu/models/speaker_inference.py).

Parity with reference preprocessing/encoder/inference.py:15-155:
  * compute_partial_slices - 50%-overlap windows of partials_n_frames mel
    frames with the min_pad_coverage tail rule (:59-108, exact math; a copy
    of dvc_tpu's numpy function);
  * embed_utterance - the mean of the partial embeddings, L2-normalized
    (:111-155), on the port's melspectrogram with one frame a hop_size;
  * embed_frames_batch - a batched forward (:43-56), one call for all
    partials of an utterance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dvc_tpu_torch.config import AudioConfig, SpeakerEncoderConfig
from dvc_tpu_torch.models.speaker_encoder import SpeakerEncoder
from dvc_tpu_torch.ops.mel import melspectrogram
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32


def compute_partial_slices(n_samples: int, partial_utterance_n_frames: int = 63,
                           min_pad_coverage: float = 0.75, overlap: float = 0.5,
                           sampling_rate: int = 16_000,
                           mel_window_step_ms: int = 10,
                           samples_per_frame: int | None = None
                           ) -> tuple[list[slice], list[slice]]:
    """Sliding-window partial slices over an utterance.

    The window/step/coverage arithmetic is a numeric parity contract with
    reference encoder/inference.py:59-108 (50%-overlap windows; a short tail
    window is kept only when it covers >= min_pad_coverage of a full one);
    computed here vectorized over all window starts at once.

    samples_per_frame overrides the ms-derived hop: the reference's encoder
    mels use a 10 ms step (160 samples), but THIS framework has one mel
    config for everything (AudioConfig.hop_size = 256) — callers slicing
    framework mels must pass that hop or the mel slices run past the frame
    count.
    """
    assert 0 <= overlap < 1
    assert 0 < min_pad_coverage <= 1

    if samples_per_frame is None:
        samples_per_frame = int(sampling_rate * mel_window_step_ms / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = max(int(np.round(partial_utterance_n_frames * (1 - overlap))), 1)

    starts = np.arange(0, max(1, n_frames - partial_utterance_n_frames
                              + frame_step + 1), frame_step)
    ends = starts + partial_utterance_n_frames

    # Tail rule: the final window runs past the signal; keep it only if the
    # real samples cover enough of it (otherwise it is mostly padding).
    tail_cover = (n_samples - starts[-1] * samples_per_frame) \
        / (partial_utterance_n_frames * samples_per_frame)
    if tail_cover < min_pad_coverage and len(starts) > 1:
        starts, ends = starts[:-1], ends[:-1]

    mel_slices = [slice(int(a), int(b)) for a, b in zip(starts, ends)]
    wav_slices = [slice(int(a) * samples_per_frame, int(b) * samples_per_frame)
                  for a, b in zip(starts, ends)]
    return wav_slices, mel_slices


@dataclass
class SpeakerEmbedder:
    """Embedding front end (role of the module-global _model in
    encoder/inference.py:11-41), on ``device`` in float32."""

    cfg: SpeakerEncoderConfig = SpeakerEncoderConfig()
    audio_cfg: AudioConfig = AudioConfig()
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        use_exact_float32()
        self.model = SpeakerEncoder(self.cfg).to(self.device).eval()
        self.loaded = False

    def load(self, state_dict: dict[str, torch.Tensor]) -> None:
        """The encoder's weights, a SpeakerEncoder state dict (a trainer's
        ``model.state_dict()``, or speaker_encoder_state_dict_from_jax of
        dvc_tpu's params)."""
        self.model.load_state_dict(state_dict)
        self.loaded = True

    def embed_frames_batch(self, frames_batch: np.ndarray) -> np.ndarray:
        """(B, n_frames, n_mels) -> (B, E)."""
        if not self.loaded:
            raise RuntimeError("call load() before inference")
        x = torch.from_numpy(np.ascontiguousarray(frames_batch, np.float32)).to(self.device)
        with torch.inference_mode():
            return self.model(x).cpu().numpy()

    def _frames(self, wav: np.ndarray) -> np.ndarray:
        w = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(self.device)
        with torch.inference_mode():
            return melspectrogram(w, self.audio_cfg).T.cpu().numpy()

    def embed_utterance(self, wav: np.ndarray, using_partials: bool = True,
                        return_partials: bool = False):
        """Waveform -> embedding (reference :111-155)."""
        if not using_partials:
            embed = self.embed_frames_batch(self._frames(wav)[None])[0]
            return (embed, None, None) if return_partials else embed

        wave_slices, mel_slices = compute_partial_slices(
            len(wav), self.cfg.partials_n_frames,
            sampling_rate=self.audio_cfg.sample_rate,
            samples_per_frame=self.audio_cfg.hop_size)
        max_wave_length = wave_slices[-1].stop
        if max_wave_length >= len(wav):
            wav = np.pad(wav, (0, max_wave_length - len(wav)))

        frames = self._frames(wav)
        frames_batch = np.stack([frames[s] for s in mel_slices])
        partial_embeds = self.embed_frames_batch(frames_batch)
        raw = partial_embeds.mean(axis=0)
        embed = raw / np.linalg.norm(raw, 2)
        if return_partials:
            return embed, partial_embeds, wave_slices
        return embed
