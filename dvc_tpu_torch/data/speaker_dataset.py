"""Speaker-verification data objects for GE2E training (a copy of
dvc_tpu/data/speaker_dataset.py; the port imports nothing of dvc_tpu).

Parity with reference preprocessing/encoder/data_objects/:
  * EpochPermutationSampler fills the role of RandomCycler
    (random_cycler.py:5-37): stream a source list in random order with the
    guarantee that over any window no element appears more than twice as
    often as any other, as concatenated full random permutations
    ("epochs") drained in order, driven by a numpy Generator;
  * Speaker.random_partial (speaker.py:22-40) + Utterance.random_partial
    (utterance.py:12-28): per speaker, sample U utterances and a random
    `n_frames` crop of each (the crop start is uniform random; the
    reference's always crops from frame 0, utterance.py:20);
  * SpeakerBatch (speaker_batch.py:6-12): stacks to (S*U, n_frames, 80).

Mels on disk are (n_mels, T) .npy files (the preprocessing layout); they are
transposed to (T, n_mels) for the time-major LSTM.  The samplers make the
same numpy draws as dvc_tpu's, so one seed gives bit-equal batches; the
DeviceResidentSampler keeps the utterance pool in one tensor on the device
and gathers the crops there.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Sequence

import numpy as np
import torch

from dvc_tpu_torch.utils.device import resolve_device


class EpochPermutationSampler:
    """Balanced infinite sampler (role of reference random_cycler.py:5-37).

    Items stream as a sequence of independent random permutations of the
    source; ``sample(count)`` returns the next ``count`` items of that
    stream, crossing epoch boundaries as needed.
    """

    def __init__(self, source: Sequence, rng: np.random.Generator | None = None):
        self.items = list(source)
        if not self.items:
            raise ValueError("cannot sample from an empty collection")
        self._rng = rng if rng is not None else np.random.default_rng()
        self._order = np.empty(0, np.intp)
        self._pos = 0

    def sample(self, count: int) -> list:
        out: list = []
        while len(out) < count:
            if self._pos == len(self._order):
                self._order = self._rng.permutation(len(self.items))
                self._pos = 0
            take = min(count - len(out), len(self._order) - self._pos)
            out.extend(self.items[j]
                       for j in self._order[self._pos:self._pos + take])
            self._pos += take
        return out

    def __next__(self):
        return self.sample(1)[0]


class Speaker:
    def __init__(self, root: str, rng: np.random.Generator | None = None):
        self.root = root
        self.name = os.path.basename(os.path.normpath(root))
        fps = sorted(glob.glob(os.path.join(root, "*.npy")))
        if not fps:
            raise Exception(f"no utterances for speaker {self.name}")
        self.utterance_fps = fps
        self.cycler = EpochPermutationSampler(fps, rng)
        self._cache: dict[str, np.ndarray] = {}

    def _frames(self, fp: str) -> np.ndarray:
        if fp not in self._cache:
            self._cache[fp] = np.load(fp).T.astype(np.float32)  # (T, n_mels)
        return self._cache[fp]

    def random_partial(self, count: int, n_frames: int,
                       rng: np.random.Generator) -> np.ndarray:
        """-> (count, n_frames, n_mels) random crops of `count` utterances."""
        fps = self.cycler.sample(count)
        n_mels = self._frames(fps[0]).shape[1]
        out = np.zeros((count, n_frames, n_mels), np.float32)
        for i, fp in enumerate(fps):
            frames = self._frames(fp)
            if len(frames) <= n_frames:
                padded = np.zeros((n_frames, frames.shape[1]), np.float32)
                padded[: len(frames)] = frames
                out[i] = padded
            else:
                start = int(rng.integers(0, len(frames) - n_frames))
                out[i] = frames[start:start + n_frames]
        return out


class SpeakerVerificationSampler:
    """Infinite batch stream: (speakers_per_batch, utts_per_speaker, n_frames,
    n_mels) — the collated SpeakerBatch of the reference DataLoader
    (speaker_verification_dataset.py:36-61)."""

    def __init__(self, dataset_root: str, speakers_per_batch: int = 64,
                 utterances_per_speaker: int = 10, n_frames: int = 63,
                 seed: int = 0, min_utterances: int = 1):
        self.rng = np.random.default_rng(seed)
        speaker_dirs = sorted(
            d for d in glob.glob(os.path.join(dataset_root, "*"))
            if os.path.isdir(d))
        self.speakers = []
        for d in speaker_dirs:
            try:
                s = Speaker(d, self.rng)
            except Exception:
                continue
            if len(s.utterance_fps) >= min_utterances:
                self.speakers.append(s)
        if not self.speakers:
            raise Exception(f"no speakers under {dataset_root}")
        self.cycler = EpochPermutationSampler(self.speakers, self.rng)
        self.s = speakers_per_batch
        self.u = utterances_per_speaker
        self.n_frames = n_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> np.ndarray:
        s_count = min(self.s, len(self.speakers))
        speakers = self.cycler.sample(s_count)
        batch = np.stack([
            spk.random_partial(self.u, self.n_frames, self.rng)
            for spk in speakers])
        return batch  # (S, U, n_frames, n_mels)


class DeviceResidentSampler:
    """GE2E batch stream with the utterance pool resident on the device.

    All utterances are padded or truncated into one (N, cap, n_mels)
    float32 tensor on ``device`` once; each step the host draws (utterance
    index, crop start) pairs with the same selection semantics and the same
    numpy draws as SpeakerVerificationSampler (per-speaker
    EpochPermutationSampler, uniform crop starts) and uploads only those
    int32 pairs; the crops are gathered on the device by index.

    Utterances longer than `max_resident_frames` are truncated for
    residency (crop starts then come from the retained prefix, a bias
    bounded by the cap; at the default 1000 frames that is 16 s of audio
    at the 256-sample hop).  Raises MemoryError if the pool exceeds
    `memory_budget_bytes`; callers fall back to the host sampler.
    """

    def __init__(self, dataset_root: str, speakers_per_batch: int = 64,
                 utterances_per_speaker: int = 10, n_frames: int = 63,
                 seed: int = 0, min_utterances: int = 1,
                 max_resident_frames: int = 1000,
                 memory_budget_bytes: int = 4 << 30,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        host = SpeakerVerificationSampler(
            dataset_root, speakers_per_batch, utterances_per_speaker,
            n_frames, seed=seed, min_utterances=min_utterances)
        self.rng = host.rng
        self.speakers = host.speakers
        self.cycler = host.cycler
        self.s, self.u, self.n_frames = host.s, host.u, host.n_frames

        fps = []
        self._fp_index: dict[str, int] = {}
        for spk in self.speakers:
            for fp in spk.utterance_fps:
                self._fp_index[fp] = len(fps)
                fps.append(fp)
        n_mels = np.load(fps[0]).shape[0]
        cap = max_resident_frames
        need = len(fps) * cap * n_mels * 4
        if need > memory_budget_bytes:
            raise MemoryError(
                f"resident pool needs {need / 2**30:.1f} GiB "
                f"(> budget {memory_budget_bytes / 2**30:.1f} GiB); "
                f"use SpeakerVerificationSampler")
        pool = np.zeros((len(fps), cap, n_mels), np.float32)
        lengths = np.zeros(len(fps), np.int64)
        for i, fp in enumerate(fps):
            mel = np.load(fp).T.astype(np.float32)  # (T, n_mels)
            t = min(len(mel), cap)
            pool[i, :t] = mel[:t]
            lengths[i] = t
        self._lengths = lengths
        self.pool = torch.from_numpy(pool).to(self.device)
        self.n_mels = n_mels
        self._frame_offsets = torch.arange(n_frames, device=self.device)

    def _draw_indices(self) -> tuple[np.ndarray, np.ndarray]:
        s_count = min(self.s, len(self.speakers))
        speakers = self.cycler.sample(s_count)
        idx = np.empty(s_count * self.u, np.int32)
        starts = np.empty(s_count * self.u, np.int32)
        k = 0
        for spk in speakers:
            for fp in spk.cycler.sample(self.u):
                i = self._fp_index[fp]
                t = self._lengths[i]
                if t <= self.n_frames:
                    start = 0  # short utterance: zero-padded in the pool
                else:
                    start = int(self.rng.integers(0, t - self.n_frames))
                idx[k] = i
                starts[k] = start
                k += 1
        return idx, starts

    def next_batch(self) -> torch.Tensor:
        """-> (S, U, n_frames, n_mels) float32 on the pool's device."""
        idx, starts = self._draw_indices()
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        rows = torch.from_numpy(starts.astype(np.int64)).to(self.device)[:, None] \
            + self._frame_offsets
        crops = self.pool[idx_t[:, None], rows]  # (S*U, n_frames, n_mels)
        return crops.reshape(len(idx) // self.u, self.u, self.n_frames, self.n_mels)

    def __iter__(self):
        while True:
            yield self.next_batch()
