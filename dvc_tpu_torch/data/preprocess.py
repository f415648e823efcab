"""Offline dataset preprocessing: audio -> per-utterance mel .npy files (port
of dvc_tpu/data/preprocess.py).

Parity with reference preprocessing/encoder/preprocess.py:78-170 and
preprocessing/dataset_preprocess.py: per speaker directory, load and
resample each file to 16 kHz, volume-normalize to -30 dBFS (increase
only), optionally VAD-trim silences (the canonical run passes --no_trim,
preprocessing.sh:1), compute the mel spectrogram, and write
``<utt>_mel.npy`` plus a ``_sources.txt`` manifest per speaker;
``skip_existing`` resumes an interrupted run from the manifest.

As dvc_tpu does it: files are loaded by an IO thread pool, bucketed by
length padded to a multiple of 16,384 samples, and mel-analyzed on the
device in batches (ops/mel.melspectrogram).  Zero padding leaves the first
num_frames(true length) frames unchanged, and only those are kept.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dvc_tpu_torch.config import AudioConfig
from dvc_tpu_torch.ops.audio import normalize_volume, resample_poly, trim_long_silences
from dvc_tpu_torch.ops.mel import melspectrogram
from dvc_tpu_torch.ops.stft import num_frames
from dvc_tpu_torch.utils.device import resolve_device
from dvc_tpu_torch.utils.wavio import read_audio

# Dataset layouts used by the reference (preprocessing/encoder/preprocess.py:
# 141-291): (subdir under datasets_root, audio extension).  Speaker names
# come out like "VCTK-Corpus_wav16_p225" (training.sh).
DATASETS = {
    "VCTK": ("VCTK-Corpus/wav16", "wav"),
    "VIVOS": ("VIVOS/wav16", "wav"),
    "VCC2020": ("vcc2020_dataset/target_task1", "wav"),
    "zalo": ("zalo_dataset", "wav"),
    # reference preprocess_librispeech (:141-151): train-other-500, flac
    "librispeech_other": ("LibriSpeech/train-other-500", "flac"),
    # reference preprocess_voxceleb1 (:236-263): wav/ subdir + anglophone
    # filter from vox1_meta.csv when present
    "voxceleb1": ("VoxCeleb1/wav", "wav"),
    # reference preprocess_voxceleb2 (:266-276): m4a, decoded by ffmpeg
    "voxceleb2": ("VoxCeleb2/dev/aac", "m4a"),
}

# reference preprocessing/encoder/config.py:45
ANGLOPHONE_NATIONALITIES = ["australia", "canada", "ireland", "uk", "usa"]


@dataclass
class PreprocessStats:
    n_files: int = 0
    n_skipped: int = 0
    n_frames: int = 0
    n_samples: int = 0


def _bucket_len(n: int, quantum: int = 1 << 14) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


class BatchedMelExtractor:
    """Batched mel extraction over length-bucketed wavs.

    backend="torch" runs ops/mel.melspectrogram on ``device``, one batch per
    bucket; backend="native" uses the port's C++ engine (native/dvc_dsp.cpp)
    on a host thread pool, for when the device is busy training;
    backend="auto" takes the native engine for fewer than ``AUTO_NATIVE_BELOW``
    wavs (no device round trip) and the device from there on, as dvc_tpu's
    (the engine must build: a failed build raises, nothing falls back).
    """

    AUTO_NATIVE_BELOW = 64

    def __init__(self, cfg: AudioConfig = AudioConfig(), batch_size: int = 16,
                 backend: str = "torch", device: str | torch.device = "cuda"):
        if backend not in ("torch", "native", "auto"):
            raise ValueError(f"unknown mel backend {backend!r}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.backend = backend
        self.device = resolve_device(device)

    def __call__(self, wavs: list[np.ndarray]) -> list[np.ndarray]:
        """List of float32 wavs -> list of (n_mels, T_i) mels (same order)."""
        if not wavs:
            return []
        c = self.cfg
        backend = self.backend
        if backend == "auto":
            backend = "native" if len(wavs) < self.AUTO_NATIVE_BELOW else "torch"
        if backend == "native":
            from dvc_tpu_torch import native
            return native.melspectrogram_batch(
                wavs, sample_rate=c.sample_rate, fft_size=c.fft_size,
                hop_size=c.hop_size, num_mels=c.num_mels, fmin=c.fmin,
                fmax=c.fmax, min_level_db=c.min_level_db, ref_level_db=c.ref_level_db)
        order = np.argsort([len(w) for w in wavs])
        out: list[np.ndarray | None] = [None] * len(wavs)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            blen = _bucket_len(max(len(wavs[j]) for j in chunk))
            batch = np.zeros((len(chunk), blen), np.float32)
            for row, j in enumerate(chunk):
                batch[row, :len(wavs[j])] = wavs[j]
            with torch.inference_mode():
                mels = melspectrogram(torch.from_numpy(batch).to(self.device), c).cpu().numpy()
            for row, j in enumerate(chunk):
                out[j] = mels[row, :, :num_frames(len(wavs[j]), c.fft_size, c.hop_size)]
        return out  # type: ignore[return-value]


def trim_wav(wav: np.ndarray, cfg: AudioConfig = AudioConfig(),
             device: str | torch.device = "cpu") -> np.ndarray:
    """The VAD trim with cfg's detector and smoothing settings."""
    kw = dict(moving_average_width=cfg.vad_moving_average_width,
              max_silence_length=cfg.vad_max_silence_length, detector=cfg.vad_detector)
    if cfg.vad_detector == "gmm":
        kw["mode"] = cfg.vad_mode
    return trim_long_silences(wav, cfg.sample_rate, cfg.vad_window_length_ms,
                              device=device, **kw)


def preprocess_wav_host(path: str, cfg: AudioConfig = AudioConfig(), trim: bool = False,
                        device: str | torch.device = "cpu") -> np.ndarray:
    """Load, resample, volume-normalize (and optionally VAD-trim) one audio
    file, wav or flac (reference preprocessing/encoder/audio.py:22-51); the
    tensor work runs on ``device``."""
    wav, sr = read_audio(path)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(device)
        if sr != cfg.sample_rate:
            x = resample_poly(x, sr, cfg.sample_rate)
        x = normalize_volume(x, cfg.audio_norm_target_dbfs, increase_only=True)
        wav = x.cpu().numpy()
    return trim_wav(wav, cfg, device) if trim else wav


def preprocess_speaker(speaker_dir: str, out_dir: str, extractor: BatchedMelExtractor,
                       cfg: AudioConfig = AudioConfig(), extension: str = "wav",
                       skip_existing: bool = False, trim: bool = False,
                       io_threads: int = 8) -> PreprocessStats:
    """One speaker directory -> ``<utt>_mel.npy`` files + ``_sources.txt``
    manifest (reference preprocess.py:83-132), on the extractor's device."""
    stats = PreprocessStats()
    speaker_name = os.path.basename(os.path.normpath(speaker_dir))
    speaker_out = os.path.join(out_dir, speaker_name)
    os.makedirs(speaker_out, exist_ok=True)
    sources_fpath = os.path.join(speaker_out, "_sources.txt")

    existing = set()
    if skip_existing and os.path.exists(sources_fpath):
        with open(sources_fpath) as f:
            existing = {line.split(",")[0] for line in f}

    jobs = []
    for root, _dirs, files in os.walk(speaker_dir):
        for fname in sorted(files):
            if not fname.endswith("." + extension):
                continue
            in_fpath = os.path.join(root, fname)
            rel = os.path.relpath(in_fpath, speaker_dir)
            out_fname = "_".join(Path(rel).parts).replace(f".{extension}", "_mel.npy")
            if out_fname in existing:
                stats.n_skipped += 1
                continue
            jobs.append((in_fpath, out_fname))

    if not jobs:
        return stats

    with ThreadPoolExecutor(io_threads) as pool:
        wavs = list(pool.map(
            lambda j: preprocess_wav_host(j[0], cfg, False, extractor.device), jobs))
    if trim:
        # in this thread, file by file: the gmm VAD's frame recurrence is a
        # loop of small torch ops, and threads running it trade the GIL at
        # every op (8 threads took 10x one thread's time on an H100 host)
        wavs = [trim_wav(w, cfg, extractor.device) for w in wavs]

    keep = [(j, w) for j, w in zip(jobs, wavs) if len(w) > 0]
    mels = extractor([w for _, w in keep])

    mode = "a" if skip_existing else "w"
    with open(sources_fpath, mode) as sources_file:
        for ((in_fpath, out_fname), wav), mel in zip(keep, mels):
            np.save(os.path.join(speaker_out, out_fname), mel)
            sources_file.write(f"{out_fname},{in_fpath}\n")
            stats.n_files += 1
            stats.n_frames += mel.shape[1]
            stats.n_samples += len(wav)
    return stats


def _voxceleb1_speaker_filter(dataset_root: str) -> set[str] | None:
    """Anglophone speaker-ID set from vox1_meta.csv, if present (reference
    preprocess_voxceleb1, preprocessing/encoder/preprocess.py:236-257)."""
    meta = os.path.join(os.path.dirname(dataset_root), "vox1_meta.csv")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    return {r[0] for r in rows
            if len(r) > 3 and r[3].strip().lower() in ANGLOPHONE_NATIONALITIES}


def preprocess_dataset(datasets_root: str, out_dir: str, dataset: str = "VCTK",
                       cfg: AudioConfig = AudioConfig(), skip_existing: bool = False,
                       trim: bool = False, batch_size: int = 16,
                       speakers: list[str] | None = None,
                       device: str | torch.device = "cuda") -> PreprocessStats:
    """A whole dataset, speaker by speaker (reference
    dataset_preprocess.py:61-73 and its per-dataset preprocess_* functions,
    encoder/preprocess.py:141-291)."""
    sub, extension = DATASETS.get(dataset, (dataset, "wav"))
    dataset_root = os.path.join(datasets_root, sub)
    if not os.path.isdir(dataset_root):
        # allow pointing straight at a directory of speaker dirs
        dataset_root = datasets_root
    os.makedirs(out_dir, exist_ok=True)
    speaker_dirs = sorted(
        os.path.join(dataset_root, d) for d in os.listdir(dataset_root)
        if os.path.isdir(os.path.join(dataset_root, d)))
    if speakers is not None:
        speaker_dirs = [d for d in speaker_dirs if os.path.basename(d) in set(speakers)]
    elif dataset == "voxceleb1":
        keep = _voxceleb1_speaker_filter(dataset_root)
        if keep is not None:
            speaker_dirs = [d for d in speaker_dirs if os.path.basename(d) in keep]
    extractor = BatchedMelExtractor(cfg, batch_size, device=device)
    total = PreprocessStats()
    for sd in speaker_dirs:
        s = preprocess_speaker(sd, out_dir, extractor, cfg, extension=extension,
                               skip_existing=skip_existing, trim=trim)
        total.n_files += s.n_files
        total.n_skipped += s.n_skipped
        total.n_frames += s.n_frames
        total.n_samples += s.n_samples
    return total
