"""Offline WORLD-feature preprocessing: wav -> per-utterance .npz (port of
dvc_tpu/data/world_preprocess.py).

The reference's WORLD pipeline (preprocessing/WORLD_processing.py:262-299
``preprocess_voice`` and the normalization of :302-348): per speaker, the
f0 and mel-cepstra of every utterance, the speaker's mcc mean/std and
log-f0 statistics, then ``<utt>.npz`` with keys (f0, mcc, normalized_mc,
mc_mean, mc_std), the contract PairedMCCDataset reads, beside
``log_f0_<spk>.npz`` and ``mcep_<spk>.npz`` in the output directory.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dvc_tpu_torch.ops.audio import resample_poly
from dvc_tpu_torch.ops.world import (logf0_statistics, mcs_normalization_fit_transform,
                                     world_decompose_batch, world_encode_data)
from dvc_tpu_torch.utils.device import resolve_device
from dvc_tpu_torch.utils.wavio import read_wav


def preprocess_world_speaker(speaker_dir: str, out_dir: str, sample_rate: int = 16_000,
                             num_mcep: int = 36, frame_period: float = 5.0,
                             save_sp_ap: bool = False, f0_mode: str = "native",
                             device: str | torch.device = "cuda") -> dict:
    """One speaker directory of wavs -> npz features and statistics files.

    f0_mode "native" analyzes one utterance at a time, Harvest and D4C in
    the C++ engine on a thread pool over files and CheapTrick on
    ``device``; "device" runs the batched analysis on ``device``
    (world_decompose_batch: Harvest, CheapTrick and the mel-cepstrum)."""
    spk = os.path.basename(os.path.normpath(speaker_dir))
    wav_fps = sorted(glob.glob(os.path.join(speaker_dir, "*.wav")))
    if not wav_fps:
        # no out_dir subdirectory either: PairedMCCDataset would count it
        print(f"  {spk}: no .wav files, skipped")
        return {"speaker": spk, "n_files": 0, "n_frames": 0}
    spk_out = os.path.join(out_dir, spk)
    os.makedirs(spk_out, exist_ok=True)
    dev = resolve_device(device)

    def load(fp):
        wav, sr = read_wav(fp)
        if sr != sample_rate:
            with torch.inference_mode():
                wav = resample_poly(torch.from_numpy(wav).to(dev), sr, sample_rate).cpu().numpy()
        return wav / max(1e-8, np.abs(wav).max())  # librosa.util.normalize

    if f0_mode == "device":
        decomposed = world_decompose_batch([load(fp) for fp in wav_fps], sample_rate,
                                           frame_period, num_mcep, keep_sp_ap=save_sp_ap,
                                           device=dev)
        feats = [(fp, f0, sp, ap, mc) for fp, (f0, _, sp, ap, mc) in zip(wav_fps, decomposed)]
        return _write_speaker_outputs(spk, spk_out, out_dir, feats, save_sp_ap)
    if f0_mode != "native":
        raise ValueError(f"unknown f0_mode {f0_mode!r}")

    def analyze(fp):
        f0, _, sp, ap, mc = world_encode_data(load(fp), sample_rate, frame_period, num_mcep,
                                              device=dev)
        return fp, f0, sp, ap, mc

    # a thread pool over files (the native stages release the GIL), with
    # the engine's own pools at one worker meanwhile so the cores are not
    # oversubscribed (its results are the same at any thread count)
    workers = min(8, max(1, os.cpu_count() or 1))
    if workers > 1 and len(wav_fps) > 1:
        prev = os.environ.get("DVC_WORLD_THREADS")
        os.environ["DVC_WORLD_THREADS"] = "1"
        try:
            with ThreadPoolExecutor(workers) as pool:
                feats = list(pool.map(analyze, wav_fps))
        finally:
            if prev is None:
                os.environ.pop("DVC_WORLD_THREADS", None)
            else:
                os.environ["DVC_WORLD_THREADS"] = prev
    else:
        feats = [analyze(fp) for fp in wav_fps]
    return _write_speaker_outputs(spk, spk_out, out_dir, feats, save_sp_ap)


def _write_speaker_outputs(spk: str, spk_out: str, out_dir: str, feats: list,
                           save_sp_ap: bool) -> dict:
    # per-speaker statistics (reference :278-292 and the :340-346 norm path)
    all_mc = np.concatenate([mc for _, _, _, _, mc in feats], axis=0)
    _, mc_mean, mc_std = mcs_normalization_fit_transform(all_mc.T)
    logf0_mean, logf0_std = logf0_statistics(np.concatenate([f0 for _, f0, _, _, _ in feats]))
    np.savez(os.path.join(out_dir, f"log_f0_{spk}.npz"), mean=logf0_mean, std=logf0_std)
    np.savez(os.path.join(out_dir, f"mcep_{spk}.npz"), mean=mc_mean, std=mc_std)
    for fp, f0, sp, ap, mc in feats:
        out_fn = os.path.splitext(os.path.basename(fp))[0] + ".npz"
        normalized_mc = (mc - mc_mean.T) / mc_std.T  # (T, n_mcep)
        payload = dict(f0=f0, mcc=mc, normalized_mc=normalized_mc, mc_mean=mc_mean.T,
                       mc_std=mc_std.T)
        if save_sp_ap:
            payload.update(sp=sp, ap=ap)
        np.savez(os.path.join(spk_out, out_fn), **payload)
    return {"speaker": spk, "n_files": len(feats), "logf0_mean": logf0_mean,
            "logf0_std": logf0_std}


def preprocess_world_dataset(dataset_fp: str, out_dir: str, sample_rate: int = 16_000,
                             num_mcep: int = 36, frame_period: float = 5.0,
                             f0_mode: str = "native",
                             device: str | torch.device = "cuda") -> list[dict]:
    """Every speaker directory under dataset_fp (the reference's loop over
    speakers, :302-348)."""
    os.makedirs(out_dir, exist_ok=True)
    stats = []
    for d in sorted(os.listdir(dataset_fp)):
        full = os.path.join(dataset_fp, d)
        if os.path.isdir(full):
            stats.append(preprocess_world_speaker(full, out_dir, sample_rate, num_mcep,
                                                  frame_period, f0_mode=f0_mode, device=device))
    return stats
