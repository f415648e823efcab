"""Equal-error-rate for the GE2E speaker encoder (a copy of dvc_tpu/eval/eer.py;
the port imports nothing of dvc_tpu).

Parity with reference preprocessing/encoder/model.py:129-137, which builds an
ROC from the flattened similarity matrix (sklearn.roc_curve) and solves
1 - x = tpr(x) by Brent's method.  Here the ROC is computed directly in
numpy and the EER is the crossing of FPR and 1-TPR on the sorted-threshold
curve (identical value, no sklearn/scipy dependency)."""

from __future__ import annotations

import numpy as np


def equal_error_rate(labels: np.ndarray, scores: np.ndarray) -> float:
    """labels: 0/1 array; scores: same-shape similarity scores."""
    labels = np.asarray(labels).ravel().astype(bool)
    scores = np.asarray(scores).ravel().astype(np.float64)
    order = np.argsort(-scores)
    labels = labels[order]
    p = labels.sum()
    n = len(labels) - p
    if p == 0 or n == 0:
        return 0.0
    tp = np.cumsum(labels)
    fp = np.cumsum(~labels)
    tpr = tp / p
    fpr = fp / n
    fnr = 1.0 - tpr
    idx = np.nanargmin(np.abs(fnr - fpr))
    return float((fnr[idx] + fpr[idx]) / 2.0)


def ge2e_eer(sim_matrix: np.ndarray, speakers_per_batch: int,
             utterances_per_speaker: int) -> float:
    """EER from the (S*U, S) similarity matrix, one-hot ground truth as in
    the reference (inv_argmax at encoder/model.py:130-131)."""
    ground_truth = np.repeat(np.arange(speakers_per_batch), utterances_per_speaker)
    labels = np.eye(speakers_per_batch, dtype=int)[ground_truth]
    return equal_error_rate(labels.flatten(), sim_matrix.flatten())


def verification_eer(embeds: np.ndarray, speaker_ids: np.ndarray,
                     max_pairs: int = 200_000, seed: int = 0) -> float:
    """Verification EER over utterance embeddings with speaker labels:
    cosine scores of all same-speaker pairs vs a sampled set of
    cross-speaker pairs (capped at max_pairs for very large sets).

    Additive evaluation tool — the reference only reports the GE2E
    training-batch EER (encoder/model.py:129-137); this scores a trained
    encoder on an arbitrary labeled corpus."""
    embeds = np.asarray(embeds, np.float64)
    embeds = embeds / np.maximum(
        np.linalg.norm(embeds, axis=1, keepdims=True), 1e-12)
    ids = np.asarray(speaker_ids)
    n = len(ids)
    iu, ju = np.triu_indices(n, k=1)
    same = ids[iu] == ids[ju]
    pos = np.flatnonzero(same)
    neg = np.flatnonzero(~same)
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    rng = np.random.RandomState(seed)
    if len(pos) > max_pairs:
        pos = rng.choice(pos, max_pairs, replace=False)
    if len(neg) > max_pairs:
        neg = rng.choice(neg, max_pairs, replace=False)
    sel = np.concatenate([pos, neg])
    scores = np.einsum("ij,ij->i", embeds[iu[sel]], embeds[ju[sel]])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    return equal_error_rate(labels, scores)
