"""Mel-cepstral distortion (MCD) evaluation (port of dvc_tpu/eval/mcd.py).

Parity with reference preprocessing/MCD_calculate.py:54-98: WORLD-extract
MCCs of source and converted wavs, drop unvoiced (f0 == 0) frames,
DTW-align on the first 24 MCCs, then
    MCD = mean( 10/ln10 * sqrt(2 * sum(diff^2)) )            (:92-93).

As in dvc_tpu, the alignment is exact dynamic-programming DTW with
fastdtw's euclidean metric (the reference's fastdtw approximates it).  The
accumulation and backtrack run in the native engine (native/dvc_dsp.cpp),
which must build: there is no Python fallback.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

NOT_PORTED = "not yet ported — see ROADMAP.md"


def dtw_path(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact DTW alignment path between (N, D) and (M, D) under euclidean
    distance: (path_x, path_y) index arrays.  The distance matrix is
    numpy float64; the O(N M) accumulation runs in C++ without the GIL, so
    evaluate_mcd_wav's threads overlap."""
    from dvc_tpu_torch import native

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    dist = np.sqrt(np.maximum(0.0, (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :]
                              - 2.0 * x @ y.T))
    return native.dtw_path(dist)


def mcd_from_mcc(src_mcc: np.ndarray, trg_mcc: np.ndarray,
                 src_f0: np.ndarray | None = None,
                 trg_f0: np.ndarray | None = None,
                 num_coeffs: int = 24) -> float:
    """MCD between two MCC sequences, the reference math (:79-93):
    voiced-only frames (f0 > 0), the first ``num_coeffs`` coefficients,
    DTW alignment, 10/ln10 * sqrt(2 * sum diff^2) averaged over the path."""
    src_v = src_mcc[np.where(src_f0 > 0)[0]] if src_f0 is not None else src_mcc
    trg_v = trg_mcc[np.where(trg_f0 > 0)[0]] if trg_f0 is not None else trg_mcc
    if len(src_v) == 0 or len(trg_v) == 0:
        # one side has no voiced frame (fastdtw crashes there, the reference
        # leaves it undefined): fall back to all frames, as dvc_tpu does;
        # nan only if a wav gave no frame at all
        src_v, trg_v = src_mcc, trg_mcc
        if len(src_v) == 0 or len(trg_v) == 0:
            return float("nan")
    src_mcc = src_v[:, :num_coeffs]
    trg_mcc = trg_v[:, :num_coeffs]
    px, py = dtw_path(src_mcc, trg_mcc)
    diff2sum = np.sum((src_mcc[px] - trg_mcc[py]) ** 2, axis=1)
    return float(np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * diff2sum)))


def analyze_wavs(wavs: list[np.ndarray], fs: int = 16_000,
                 device: str | torch.device = "cuda") -> list[tuple[np.ndarray, np.ndarray]]:
    """(f0, mcc) of each wav through world_encode_data, on a thread pool
    of up to 8 (Harvest and D4C release the GIL in C++)."""
    from dvc_tpu_torch.ops.world import world_encode_data

    def analyze(wav):
        f0, _, _, _, mc = world_encode_data(wav, fs, device=device)
        return f0, mc

    workers = min(8, max(1, len(wavs)))
    if workers == 1:
        return [analyze(w) for w in wavs]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(analyze, wavs))


def evaluate_mcd_wav(src_wavs: list[np.ndarray], trg_wavs: list[np.ndarray],
                     fs: int = 16_000, analysis: str = "native",
                     device: str | torch.device = "cuda") -> list[float]:
    """Waveform-level MCD list (reference evaluate_mcd_wav :54-98): f0 and
    MCC of every wav by the WORLD analysis (ops/world.py: Harvest and D4C
    on the host, CheapTrick and the mel-cepstrum on ``device``), then the
    per-utterance MCD of each pair.  analysis="device" (dvc_tpu's
    corpus-batched device Harvest/D4C) is not ported."""
    if analysis == "device":
        raise NotImplementedError(f'analysis="device" (world_decompose_batch) is {NOT_PORTED}')
    if analysis != "native":
        raise ValueError(f"unknown analysis {analysis!r}")
    feats = analyze_wavs(list(src_wavs) + list(trg_wavs), fs, device)
    n = len(src_wavs)
    return [mcd_from_mcc(mc_s, mc_t, f0_s, f0_t)
            for (f0_s, mc_s), (f0_t, mc_t) in zip(feats[:n], feats[n:])]
