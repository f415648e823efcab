"""Host-side paired-utterance data pipeline (a copy of
dvc_tpu/data/dataset.py:28-156,187-192; the port imports nothing of
dvc_tpu).

Reference preprocessing/dataset.py:53-117 (SpeechDatasetGVAE): per speaker,
shuffle the utterance list, split it in half and zip the halves into (utt1,
utt2) same-speaker pairs; each item random-crops (or zero-pads) both mels
to ``samples_length`` frames; ``shuffle_data()`` re-pairs everything between
epochs.  One seed gives the same pairs, crops and batch order as dvc_tpu's.
Batches are contiguous numpy arrays; the trainer moves them to the device.
The WORLD-feature variant (PairedMCCDataset) comes with the WORLD path.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator

import numpy as np


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a background thread, buffering `depth` items, so
    host-side batch assembly overlaps device execution (the role of the
    torch DataLoader workers the reference relies on — train.py:55).

    Exceptions from the wrapped iterator re-raise in the CONSUMER — a
    worker-thread error must fail the training loop, not silently end the
    epoch early."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in iterator:
                q.put((None, item))
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            q.put((e, None))
            return
        q.put((None, done))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        err, item = q.get()
        if err is not None:
            raise err
        if item is done:
            return
        yield item


class _PairedDatasetBase:
    pattern = "*.npy"
    samples_length = 64

    def __init__(self, file_path: str, samples_length: int | None = None,
                 seed: int | None = None, cache: bool = True):
        self.file_path = file_path
        if samples_length is not None:
            self.samples_length = samples_length
        self._rng = np.random.RandomState(seed)
        self.cache_enabled = cache
        self._cache: dict[str, np.ndarray] = {}

        # directories only: WORLD preprocessing writes per-speaker stats
        # files (mcep_<spk>.npz, log_f0_<spk>.npz) into the same out_dir
        self.speaker_ids = sorted(
            d for d in os.listdir(file_path)
            if os.path.isdir(os.path.join(file_path, d)))
        self.spk_utt: list[np.ndarray] = []
        for spk in self.speaker_ids:
            utts = np.array(sorted(
                glob.glob(os.path.join(file_path, spk, self.pattern))))
            self.spk_utt.append(utts)
        self.utterance_fp = np.empty((0, 2), dtype=object)
        self.shuffle_data()

    # -- pairing (reference dataset.py:63-91) --------------------------------

    def shuffle_data(self) -> None:
        pairs = []
        for utts in self.spk_utt:
            self._rng.shuffle(utts)
            half = len(utts) // 2
            u1, u2 = utts[:half], utts[half: 2 * half]
            pairs.extend(zip(u1, u2))
        self.utterance_fp = np.array(pairs, dtype=object).reshape(-1, 2)

    def __len__(self) -> int:
        return len(self.utterance_fp)

    # -- IO ------------------------------------------------------------------

    def _load(self, fp: str) -> np.ndarray:
        if self.cache_enabled and fp in self._cache:
            return self._cache[fp]
        arr = self._read(fp)
        if self.cache_enabled:
            self._cache[fp] = arr
        return arr

    def _read(self, fp: str) -> np.ndarray:  # (n_feats, T)
        return np.load(fp)

    def _crop_or_pad(self, mel: np.ndarray) -> np.ndarray:
        t = mel.shape[1]
        L = self.samples_length
        if t < L:
            return np.pad(mel, ((0, 0), (0, L - t)))
        if t == L:
            # reference np.random.choice(0) would raise; only reachable for
            # mel pattern (strict <); keep the full mel
            return mel
        start = self._rng.randint(0, t - L)
        return mel[:, start:start + L]

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray, int]:
        fp1, fp2 = self.utterance_fp[index]
        mel1 = self._crop_or_pad(self._load(fp1))
        mel2 = self._crop_or_pad(self._load(fp2))
        spk = self.speaker_ids.index(os.path.basename(os.path.dirname(fp1)))
        return mel1.astype(np.float32), mel2.astype(np.float32), spk

    # -- batching ------------------------------------------------------------

    def batches(self, batch_size: int, shuffle: bool = True, drop_remainder: bool = True
                ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (x1, x2, spk_ids) numpy batches; partial batches are dropped
        by default, as dvc_tpu drops them (the reference's DataLoader keeps
        them)."""
        order = np.arange(len(self))
        if shuffle:
            self._rng.shuffle(order)
        n_full = len(order) // batch_size
        for b in range(n_full):
            idx = order[b * batch_size:(b + 1) * batch_size]
            items = [self[i] for i in idx]
            x1 = np.stack([it[0] for it in items])
            x2 = np.stack([it[1] for it in items])
            spk = np.array([it[2] for it in items], np.int32)
            yield x1, x2, spk
        if not drop_remainder and len(order) % batch_size:
            idx = order[n_full * batch_size:]
            items = [self[i] for i in idx]
            yield (np.stack([it[0] for it in items]),
                   np.stack([it[1] for it in items]),
                   np.array([it[2] for it in items], np.int32))

    def get_utterance(self, speaker: str, utterance: str) -> np.ndarray:
        return self._read(os.path.join(self.file_path, speaker, utterance))


class PairedMelDataset(_PairedDatasetBase):
    """Mel (.npy, (80, T)) pairs — reference SpeechDatasetGVAE."""

    pattern = "*.npy"
    samples_length = 64
