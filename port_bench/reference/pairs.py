"""What a paired training batch must hold, read against the corpus files.

Each row is a crop of ``frames`` frames of one utterance of the corpus
(zero-padded past the utterance's end, as the reference pads a short
one), and the two rows of a pair are two different utterances of one
speaker.  The rows are found by their first frame, then compared whole and
exactly: the files are float32 and a batch carries them unchanged.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def load_corpus(root: str, kind: str) -> tuple[list[np.ndarray], list[str]]:
    """Every utterance under ``root/<speaker>/`` as (dims, T) float32, and
    its speaker."""
    feats, spks = [], []
    for fp in sorted(glob.glob(os.path.join(root, "*", "*.npy" if kind == "mel" else "*.npz"))):
        if kind == "mel":
            a = np.load(fp)
        else:
            with np.load(fp) as z:
                a = z["normalized_mc"].T
        feats.append(np.ascontiguousarray(a, np.float32))
        spks.append(os.path.basename(os.path.dirname(fp)))
    return feats, spks


def _keys(cols: np.ndarray) -> np.ndarray:
    """A 64-bit key of each frame (column) from its first two values' bits."""
    bits = np.ascontiguousarray(cols[:2].T).view(np.uint32).astype(np.uint64)
    return bits[:, 0] << np.uint64(32) | bits[:, 1]


class Corpus:
    def __init__(self, root: str, kind: str):
        self.feats, self.spks = load_corpus(root, kind)
        keys = np.concatenate([_keys(f) for f in self.feats])
        fid = np.concatenate([np.full(f.shape[1], i, np.int64) for i, f in enumerate(self.feats)])
        off = np.concatenate([np.arange(f.shape[1]) for f in self.feats])
        order = np.argsort(keys, kind="stable")
        self.keys, self.fid, self.off = keys[order], fid[order], off[order]

    def utterance_of(self, row: np.ndarray) -> int | None:
        """The index of the utterance that ``row`` (dims, frames) is a crop
        of, or None."""
        k = _keys(row[:, :1])[0]
        lo, hi = np.searchsorted(self.keys, np.array([k, k + np.uint64(1)], np.uint64))
        n = row.shape[1]
        for j in range(lo, hi):
            f, o = self.feats[self.fid[j]], self.off[j]
            want = np.zeros_like(row)
            part = f[:, o:o + n]
            want[:, :part.shape[1]] = part
            if np.array_equal(want, row):
                return int(self.fid[j])
        return None

    def rows_off(self, x1: np.ndarray, x2: np.ndarray) -> int:
        """How many pairs of the batch (x1[i], x2[i]) are not two crops of
        different utterances of one speaker."""
        bad = 0
        for a, b in zip(x1, x2):
            u, v = self.utterance_of(a), self.utterance_of(b)
            bad += u is None or v is None or u == v or self.spks[u] != self.spks[v]
        return bad
