"""HTTP voice-conversion service with cross-request micro-batching (port of
dvc_tpu/serve.py).

  * target-speaker styles are computed once per speaker (mean style_mu over
    all of the speaker's 64-frame chunks) and cached on the device;
  * concurrent requests drain into one batch: their chunks concatenate on
    the chunk axis, run through one encode/decode/postnet pass and are split
    back per request;
  * chunk-axis batch sizes are bucketed to powers of two (padded chunks are
    discarded), so a handful of shapes recur;
  * the vocoder runs through its ``.batch`` path: one CUDA kernel call for
    the whole drain;
  * a request that fails (unknown speaker, corrupt mel on disk) fails alone.

Endpoints (stdlib http.server):
  GET  /health                      -> {"status": "ok", "speakers": [...]}
  GET  /stats                       -> counters incl. batching ratio
  POST /convert?trg_spk=<spk>       -> body: wav bytes at any sample rate
                                       (resampled to 16 kHz on the service's
                                       device); reply: wav bytes (npy bytes of
                                       the mel without a vocoder)

Three services share the queue and worker: ConversionService (the VAE latent
swap), ProfileTransferService (``serve --profile_transfer``, the model-free
DSP route) and WorldConversionService (``serve --pipeline world``, the
MCC-VAE on WORLD features, analyzed and synthesized on the device).

While a torch.profiler records, a request records spans
(utils/profiling.py) that carry its ``rid``: ``serve.front_end``,
``serve.queue`` (from entering the queue to the start of its drain's work,
the batching window included) and ``serve.reply``; a ConversionService
drain records ``serve.vae``, and the WaveNet vocoder's launch
``vocoder.sample``.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from glob import glob
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from dvc_tpu_torch.config import Config
from dvc_tpu_torch.convert.conversion import profile_transfer_mel, speaker_mel_profile
from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
from dvc_tpu_torch.ops.audio import resample_poly
from dvc_tpu_torch.ops.chunk import chunk_mel, num_chunks
from dvc_tpu_torch.ops.mel import melspectrogram
from dvc_tpu_torch.ops.stft import num_frames
from dvc_tpu_torch.ops.world import (cheaptrick_fft_size, logf0_statistics, mc2sp, mcepalpha,
                                     pitch_conversion, synthesize_batch, world_decompose_batch)
from dvc_tpu_torch.utils.device import resolve_device, use_exact_float32
from dvc_tpu_torch.utils.profiling import interval, span
from dvc_tpu_torch.utils.wavio import parse_wav, wav_bytes


class ServiceOverloaded(Exception):
    """Request queue at capacity — clients should back off (HTTP 503)."""


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


_RIDS = itertools.count(1)
_handling = threading.local()  # .rid: the request an HTTP handler thread serves


def _request_id() -> int:
    """The id the HTTP handler drew for the request its thread serves (its
    spans carry it), else a new one."""
    return getattr(_handling, "rid", None) or next(_RIDS)


@dataclass
class _Request:
    payload: np.ndarray                   # mel (80, T), or a 16 kHz wav (N,)
    trg_spk: str
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    error: BaseException | None = None
    abandoned: bool = False               # submit timed out; skip the work
    t_submit: float = field(default_factory=time.monotonic)
    rid: int = field(default_factory=_request_id)
    t_queued_ns: int = field(default_factory=time.time_ns)  # made as it enters the queue


class _MicroBatchService:
    """Queue and worker shared by the services: concurrent requests drain
    into one batch (submit/_drain/_run); subclasses implement
    _process(batch).  A request's cost is its number of 64-frame chunks.
    ``input_kind`` is what a request carries: its mel, or its wav at the
    model's sample rate."""

    input_kind = "mel"

    def _start(self, cfg: Config, dataset_fp: str, vocoder, device,
               max_batch_chunks: int, max_wait_ms: float, max_queue: int):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset_fp = dataset_fp
        self.vocoder = vocoder
        self.output_is_wav = vocoder is not None
        self._frames = cfg.vae.frames
        self.max_wait_ms = max_wait_ms
        self.max_batch_cost = max_batch_chunks
        self._q: queue.Queue[_Request] = queue.Queue(maxsize=max_queue)
        self.stats = {"requests": 0, "batches": 0, "chunks": 0, "errors": 0}
        self._latencies: list[float] = []  # rolling window, seconds
        # guards stats/_latencies: written by the worker, read by /stats
        self._stats_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def speakers(self) -> list[str]:
        return sorted(d for d in os.listdir(self.dataset_fp)
                      if os.path.isdir(os.path.join(self.dataset_fp, d)))

    def _process(self, batch: list[_Request]) -> None:
        raise NotImplementedError

    def _vocode(self, mels: list[np.ndarray]) -> list[np.ndarray]:
        if self.vocoder is None:
            return mels  # mel-out mode: return the mel itself
        batch_fn = getattr(self.vocoder, "batch", None)
        return batch_fn(mels) if batch_fn is not None else [self.vocoder(m) for m in mels]

    # -- queue and worker ----------------------------------------------------

    def submit(self, payload: np.ndarray, trg_spk: str, timeout: float = 120.0) -> np.ndarray:
        req = _Request(payload=payload, trg_spk=trg_spk)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            raise ServiceOverloaded(
                f"request queue at capacity ({self._q.maxsize})") from None
        if not req.done.wait(timeout):
            # the worker skips device work for a reply nobody will read
            req.abandoned = True
            raise TimeoutError("conversion timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def _cost(self, req: _Request) -> int:
        return num_chunks(req.payload.shape[1], self._frames)

    def _drain(self) -> list[_Request]:
        """One micro-batch: block for the first request, then keep draining
        until the chunk budget or the wait window is exhausted."""
        first = self._q.get()
        batch = [first]
        cost = self._cost(first)
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while cost < self.max_batch_cost:
            remain = deadline - time.monotonic()
            if remain <= 0:
                break
            try:
                nxt = self._q.get(timeout=remain)
            except queue.Empty:
                break
            batch.append(nxt)
            cost += self._cost(nxt)
        return batch

    def _run(self):
        while True:
            batch = self._drain()
            t = time.time_ns()
            for r in batch:  # each request's wait, the batching window included
                interval("serve.queue", r.t_queued_ns, t, rid=r.rid)
            try:
                self._process(batch)
            except Exception as e:  # the worker must outlive a failed batch
                with self._stats_lock:
                    self.stats["errors"] += len(batch)
                for r in batch:
                    r.error = e
                    r.done.set()

    def _fail_request(self, r: _Request, e: BaseException):
        r.error = e
        r.done.set()
        with self._stats_lock:
            self.stats["errors"] += 1

    def _finish(self, owners: list[_Request], results: list[np.ndarray], n_chunks: int):
        now = time.monotonic()
        for r, w in zip(owners, results):
            r.result = np.asarray(w)
            r.done.set()
        with self._stats_lock:
            self._latencies.extend(now - r.t_submit for r in owners)
            del self._latencies[:-512]  # rolling window
            self.stats["requests"] += len(owners)
            self.stats["batches"] += 1
            self.stats["chunks"] += n_chunks


class ConversionService(_MicroBatchService):
    """Mel conversion engine with a micro-batching worker thread.

    ``model`` is a DisentangledVAE; it is moved to ``device`` and served in
    eval mode and float32."""

    def __init__(self, cfg: Config, model: DisentangledVAE, dataset_fp: str,
                 vocoder=None, max_batch_chunks: int = 64, max_wait_ms: float = 10.0,
                 max_queue: int = 256, fs_mask: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        # float32 VAE: cuDNN convolutions default to TF32, which the
        # reference parity does not allow
        use_exact_float32()
        self.model = model.to(dev).eval()
        self._mask = None if fs_mask is None else torch.as_tensor(
            np.asarray(fs_mask, np.float32), device=dev)
        self._style_cache: dict[str, torch.Tensor] = {}
        self._style_lock = threading.Lock()
        self._start(cfg, dataset_fp, vocoder, dev, max_batch_chunks, max_wait_ms,
                    max_queue)

    # -- model passes --------------------------------------------------------

    @torch.inference_mode()
    def _convert(self, chunks: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """chunks (N, 80, F), styles (N, D): encode the source content, swap
        in the cached target vector, decode + postnet, clamp.

        Plain swap: styles are the target's mean style_mu.  FS-masked swap:
        styles are the target's mean FULL latent, taken on every masked dim
        (the style dims always are), so source style never reaches the
        decoder."""
        m = self.model
        style_mu, _, content_mu, _ = m.encode(chunks)
        if self._mask is None:
            z = torch.cat([styles, content_mu], -1)
        else:
            src_z = torch.cat([style_mu, content_mu], -1)
            z = src_z * (1.0 - self._mask) + styles * self._mask
        mel = m.decode(z)
        mel = mel + m.postnet(mel)
        return torch.clamp(mel, 0.0, 1.0)

    @torch.inference_mode()
    def _style_of(self, chunks: torch.Tensor) -> torch.Tensor:
        style_mu, _, content_mu, _ = self.model.encode(chunks)
        if self._mask is None:
            return style_mu.mean(0)
        return torch.cat([style_mu, content_mu], -1).mean(0)

    # -- target styles -------------------------------------------------------

    def target_style(self, spk: str) -> torch.Tensor:
        with self._style_lock:
            hit = self._style_cache.get(spk)
            if hit is not None:
                return hit
        fps = sorted(glob(os.path.join(self.dataset_fp, spk, "*.npy")))
        if not fps:
            raise KeyError(f"unknown target speaker {spk!r}")
        chunks = [chunk_mel(torch.as_tensor(np.load(fp), dtype=torch.float32,
                                            device=self.device), self._frames)
                  for fp in fps]
        style = self._style_of(torch.cat(chunks, 0))
        with self._style_lock:
            self._style_cache[spk] = style
        return style

    def _process(self, batch: list[_Request]):
        frames = self._frames
        all_chunks, styles, spans = [], [], []
        offset = 0
        with span("serve.vae"):
            for r in batch:
                if r.abandoned:
                    continue
                try:
                    style = self.target_style(r.trg_spk)
                except Exception as e:
                    # a per-request failure must not poison co-batched requests
                    self._fail_request(r, e)
                    continue
                c = chunk_mel(torch.as_tensor(r.payload, dtype=torch.float32,
                                              device=self.device), frames)
                spans.append((r, offset, c.shape[0]))
                offset += c.shape[0]
                all_chunks.append(c)
                styles.append(style[None, :].expand(c.shape[0], -1))
            if not all_chunks:
                return
            chunks = torch.cat(all_chunks, 0)
            style_arr = torch.cat(styles, 0)
            n = chunks.shape[0]
            nb = _bucket(max(n, 1))
            if nb > n:  # pad to the bucket; padded chunks are discarded below
                chunks = torch.cat([chunks, chunks.new_zeros((nb - n,) + chunks.shape[1:])])
                style_arr = torch.cat([style_arr,
                                       style_arr.new_zeros(nb - n, style_arr.shape[-1])])
            out = self._convert(chunks, style_arr)[:n].cpu().numpy()

        mels, owners = [], []
        for r, start, count in spans:
            mel = out[start:start + count]           # (count, 80, F)
            mels.append(mel.transpose(1, 0, 2).reshape(mel.shape[1], -1).astype(np.float32))
            owners.append(r)
        self._finish(owners, self._vocode(mels), n)


class ProfileTransferService(_MicroBatchService):
    """``serve --profile_transfer``: the model-free DSP conversion route
    (dvc_tpu/serve.py:318-400).

    No checkpoint: converted = the source mel shifted by (the target
    speaker's mean spectral profile - the source's), clipped to [0, 1]
    (profile_transfer_mel).  A request carries no source-speaker label, so
    the source profile is the request utterance's own time-mean mel; target
    profiles are computed once per speaker from dataset_fp and cached.  The
    vocoder is the only device work; ``device`` is where the HTTP front end
    resamples and computes mels."""

    def __init__(self, cfg: Config, dataset_fp: str, vocoder=None,
                 max_batch_chunks: int = 64, max_wait_ms: float = 10.0,
                 max_queue: int = 256, device: str | torch.device = "cuda"):
        self._prof_cache: dict[str, np.ndarray] = {}
        self._prof_lock = threading.Lock()
        self._start(cfg, dataset_fp, vocoder, device, max_batch_chunks, max_wait_ms,
                    max_queue)

    def target_profile(self, spk: str) -> np.ndarray:
        with self._prof_lock:
            hit = self._prof_cache.get(spk)
            if hit is not None:
                return hit
        fps = sorted(glob(os.path.join(self.dataset_fp, spk, "*.npy")))
        if not fps:
            raise KeyError(f"unknown target speaker {spk!r}")
        prof = speaker_mel_profile(fps)
        with self._prof_lock:
            self._prof_cache[spk] = prof
        return prof

    def _process(self, batch: list[_Request]):
        mels, owners, n = [], [], 0
        for r in batch:
            if r.abandoned:
                continue
            try:
                prof = self.target_profile(r.trg_spk)
            except Exception as e:
                self._fail_request(r, e)
                continue
            src = np.asarray(r.payload, np.float32)
            mels.append(profile_transfer_mel(src, src.mean(axis=1), prof))
            owners.append(r)
            n += num_chunks(src.shape[1], self._frames)
        if owners:
            self._finish(owners, self._vocode(mels), n)


class WorldConversionService(_MicroBatchService):
    """``serve --pipeline world``: the MCC/WORLD conversion route, batched
    (dvc_tpu/serve.py:392-603).  Every stage of a drained micro-batch runs
    on ``device``:

      16 kHz wavs -> the batched WORLD analysis (world_decompose_batch:
      Harvest, CheapTrick, the mel-cepstrum) -> each utterance normalized
      by its own MCC statistics -> one chunk-axis VAE pass (the target's
      cached style latent, the source's content per chunk; decode only, no
      postnet or clamp, as convert_mcc) -> the target speaker's
      de-normalization and mc2sp -> the log-Gaussian pitch transform (the
      source's log-f0 statistics fitted on the request itself, since the
      client's speaker is unknown) -> synthesize_batch -> peak
      normalization.

    dataset_fp is a preprocess-world output directory: per-speaker npz
    subdirectories and the log_f0_<spk>.npz / mcep_<spk>.npz statistics.
    A request's cost is one utterance; a drain holds up to max_batch_utts."""

    input_kind = "wav"

    def __init__(self, cfg: Config, model: DisentangledVAE, dataset_fp: str,
                 sample_rate: int = 16_000, frame_period: float = 5.0,
                 max_batch_utts: int = 16, max_wait_ms: float = 10.0, max_queue: int = 256,
                 fs_mask: np.ndarray | None = None, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        use_exact_float32()  # the VAE in float32, never TF32
        self.model = model.to(dev).eval()
        self.fs = sample_rate
        self.frame_period = frame_period
        self._n_mcep = cfg.vae.num_mels
        self._mask = None if fs_mask is None else torch.as_tensor(
            np.asarray(fs_mask, np.float32), device=dev)
        self._asset_cache: dict[str, tuple] = {}
        self._asset_lock = threading.Lock()
        self._start(cfg, dataset_fp, None, dev, max_batch_utts, max_wait_ms, max_queue)
        self.output_is_wav = True  # the synthesis is built in

    def _cost(self, req: _Request) -> int:
        return 1

    @torch.inference_mode()
    def _convert(self, chunks: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
        """chunks (N, n_mcep, F), styles (N, D) -> decoded (N, n_mcep, F):
        the plain swap takes the target's mean style_mu, the FS-masked one
        the target's mean full latent on every masked dim."""
        style_mu, _, content_mu, _ = self.model.encode(chunks)
        if self._mask is None:
            z = torch.cat([styles, content_mu], -1)
        else:
            z = torch.cat([style_mu, content_mu], -1) * (1.0 - self._mask) + styles * self._mask
        return self.model.decode(z)

    @torch.inference_mode()
    def _style_of(self, chunks: torch.Tensor) -> torch.Tensor:
        style_mu, _, content_mu, _ = self.model.encode(chunks)
        if self._mask is None:
            return style_mu.mean(0)
        return torch.cat([style_mu, content_mu], -1).mean(0)

    def target_assets(self, spk: str):
        """(style latent, mcep statistics, log-f0 statistics) of a target
        speaker, cached."""
        with self._asset_lock:
            hit = self._asset_cache.get(spk)
            if hit is not None:
                return hit
        fps = sorted(glob(os.path.join(self.dataset_fp, spk, "*.npz")))
        if not fps:
            raise KeyError(f"unknown target speaker {spk!r}")
        chunks = []
        for fp in fps:
            with np.load(fp) as z:
                chunks.append(chunk_mel(torch.as_tensor(z["normalized_mc"].T, dtype=torch.float32,
                                                        device=self.device), self._frames))
        style = self._style_of(torch.cat(chunks, 0))
        with np.load(os.path.join(self.dataset_fp, f"mcep_{spk}.npz")) as z:
            mcep = dict(z)
        with np.load(os.path.join(self.dataset_fp, f"log_f0_{spk}.npz")) as z:
            logf0 = dict(z)
        assets = (style, mcep, logf0)
        with self._asset_lock:
            self._asset_cache[spk] = assets
        return assets

    def _process(self, batch: list[_Request]):
        live = []
        for r in batch:
            if r.abandoned:
                continue
            try:
                live.append((r, self.target_assets(r.trg_spk)))
            except Exception as e:
                self._fail_request(r, e)
        if not live:
            return

        # 1. the batched analysis
        feats = world_decompose_batch([np.asarray(r.payload, np.float32) for r, _ in live],
                                      self.fs, self.frame_period, num_mcep=self._n_mcep,
                                      keep_sp_ap=False, device=self.device)

        # 2. each utterance normalized by its own statistics and chunked ->
        # one VAE batch, padded to a power of two
        all_chunks, styles, spans = [], [], []
        offset = 0
        for (r, (style, _, _)), (f0, _, _, _, mc) in zip(live, feats):
            mean = mc.mean(axis=0, keepdims=True)
            std = np.maximum(mc.std(axis=0, keepdims=True), 1e-6)
            norm = ((mc - mean) / std).T.astype(np.float32)  # (n_mcep, T)
            c = chunk_mel(torch.as_tensor(norm, device=self.device), self._frames)
            spans.append((offset, c.shape[0], norm.shape[1], f0))
            offset += c.shape[0]
            all_chunks.append(c)
            styles.append(style[None, :].expand(c.shape[0], -1))
        chunks = torch.cat(all_chunks, 0)
        style_arr = torch.cat(styles, 0)
        n = chunks.shape[0]
        nb = _bucket(max(n, 1))
        if nb > n:  # padded chunks are discarded below
            chunks = torch.cat([chunks, chunks.new_zeros((nb - n,) + chunks.shape[1:])])
            style_arr = torch.cat([style_arr, style_arr.new_zeros(nb - n, style_arr.shape[-1])])
        out = self._convert(chunks, style_arr)[:n].cpu().numpy()

        # 3. the target's de-normalization, mc2sp, the pitch transform, and
        # one batched synthesis
        alpha, fft_size = mcepalpha(self.fs), cheaptrick_fft_size(self.fs)
        f0s, sps, aps, owners = [], [], [], []
        for (r, (_, mcep_stats, trg_lf0)), (start, count, t, f0) in zip(live, spans):
            conv = out[start:start + count]                 # (count, n_mcep, F)
            conv = conv.transpose(1, 0, 2).reshape(conv.shape[1], -1)[:, :t]
            mc = conv.T * np.asarray(mcep_stats["std"]).T + np.asarray(mcep_stats["mean"]).T
            with torch.inference_mode():
                sp = mc2sp(torch.as_tensor(mc.astype(np.float32), device=self.device), alpha,
                           fft_size).cpu().numpy()
            voiced = f0 > 0
            f0_conv = np.zeros_like(f0)
            if voiced.any():
                src_mean, src_std = logf0_statistics(f0)
                if np.isfinite(src_std) and src_std > 1e-6:
                    f0_conv[voiced] = pitch_conversion(f0[voiced], src_mean, src_std,
                                                       float(trg_lf0["mean"]),
                                                       float(trg_lf0["std"]))
                else:  # a monotone input: the target's mean pitch
                    f0_conv[voiced] = np.exp(float(trg_lf0["mean"]))
            ap = np.full((t, sp.shape[1]), 0.2, np.float32)
            ap[~voiced[:t]] = 1.0 - 1e-12
            f0s.append(f0_conv[:t])
            sps.append(sp[:t])
            aps.append(ap)
            owners.append(r)
        wavs = synthesize_batch(f0s, sps, aps, self.fs, self.frame_period, device=self.device)
        results = []
        for w in wavs:
            peak = np.abs(w).max()
            results.append(w / peak * 0.95 if peak > 1e-8 else w)
        self._finish(owners, results, n)


def make_http_server(service: _MicroBatchService, host: str = "127.0.0.1",
                     port: int = 7860) -> ThreadingHTTPServer:
    audio_cfg = service.cfg.audio

    def payload_of(wav: np.ndarray, sr: int) -> np.ndarray:
        # resample to the model's rate on the service's device; for a mel,
        # bucket the sample count to a power of two (zero-padding extends
        # the framing's own zero padding, so the first num_frames(orig)
        # frames are unchanged), then crop to the true frame count
        with torch.inference_mode():
            x = resample_poly(torch.from_numpy(wav).to(service.device), sr,
                              audio_cfg.sample_rate)
            if service.input_kind == "wav":
                return x.cpu().numpy()
            n = x.shape[-1]
            x = torch.nn.functional.pad(x, (0, _bucket(max(n, audio_cfg.hop_size)) - n))
            mel = melspectrogram(x, audio_cfg)
        return mel[:, :num_frames(n, audio_cfg.fft_size, audio_cfg.hop_size)].cpu().numpy()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self._send(code, "application/json", body)

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                self._json(200, {"status": "ok", "speakers": service.speakers()})
            elif path == "/stats":
                with service._stats_lock:
                    s = dict(service.stats)
                    lat = list(service._latencies)
                s["batching_ratio"] = s["requests"] / s["batches"] if s["batches"] else 0.0
                if lat:
                    arr = np.sort(np.asarray(lat))
                    s["latency_ms"] = {
                        "p50": round(float(arr[len(arr) // 2]) * 1e3, 1),
                        "p95": round(float(arr[int(len(arr) * 0.95)
                                               if len(arr) > 1 else 0]) * 1e3, 1),
                        "max": round(float(arr[-1]) * 1e3, 1),
                        "window": len(arr),
                    }
                self._json(200, s)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            _handling.rid = rid = next(_RIDS)
            try:
                self._post(rid)
            finally:
                _handling.rid = None

        def _post(self, rid: int):
            parsed = urlparse(self.path)
            if parsed.path != "/convert":
                self._json(404, {"error": f"unknown path {parsed.path}"})
                return
            trg = parse_qs(parsed.query).get("trg_spk", [""])[0]
            if not trg:
                self._json(400, {"error": "trg_spk query parameter required"})
                return
            if trg not in service.speakers():
                self._json(404, {"error": f"unknown target speaker {trg!r}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._json(400, {"error": "wav body required"})
                return
            body = self.rfile.read(length)
            try:
                wav, sr = parse_wav(body, "request body")
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            try:
                with span("serve.front_end", rid=rid):
                    payload = payload_of(np.asarray(wav, np.float32), sr)
                out = service.submit(payload, trg)
            except KeyError as e:
                # speaker dir listed but empty, or removed after the check
                self._json(404, {"error": str(e)})
                return
            except (ServiceOverloaded, TimeoutError) as e:
                self._json(503, {"error": str(e)})
                return
            except Exception as e:  # reported to the client, server keeps serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            with span("serve.reply", rid=rid):
                if service.output_is_wav:
                    self._send(200, "audio/wav", wav_bytes(out, audio_cfg.sample_rate))
                else:
                    buf = io.BytesIO()
                    np.save(buf, out)
                    self._send(200, "application/octet-stream", buf.getvalue())

    return ThreadingHTTPServer((host, port), Handler)
