"""Closed-loop clients posting wavs to the program's HTTP /convert endpoint.

Set-up: the VAE and the WaveNet from the seed on the device, the target
speakers' mel files under TMPDIR, ``ConversionService`` over them with the
WaveNet vocoder (its ``.batch`` wrapped to record each drain), the HTTP
server on 127.0.0.1 and a port the system picks, every request body, and a
warm-up of exactly the shapes the traffic uses, ending with one round of
the clients' first requests sent at once through HTTP (the sampler left
out of it, having been warmed at the clients' batch).

Window: the clients run in a process of their own (``loadgen.py``, the
standard library alone), as a deployment's clients do not share the
server's interpreter; each posts its next body when the last reply has
come, and sends nothing once ``--seconds`` have passed; replies to
requests already sent are awaited.  Each request's wait in the service's
queue is a ``serve.submit`` span, around the service's ``submit``.  Lengths are one fixed stratified set a round (every
seed serves the same sizes, in its own order), wavs at the traffic's rate
(16-bit PCM), target speakers drawn uniformly.

Judged after the window: a sample of the finished requests drawn from the
seed, the longest among them, against the plain reference
(reference/audio.py, reference/vae.py, reference/wavenet.py).
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from port_bench import common, corpus
from port_bench.reference import audio as ref_audio
from port_bench.reference import vae as ref_vae
from port_bench.reference import wavenet as ref_wn
from port_bench.trace import DeviceTrace, Spans
from port_bench.weights import vae_state_dict, vocoder_state_dict

SEEDS = ("vae", "voc", "voc_seed", "speakers", "bodies", "order", "judge")


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def program_config(cfg: dict):
    from dvc_tpu_torch.config import AudioConfig, Config, VAEConfig, VocoderConfig
    voc = dict(cfg["vocoder"], upsample_scales=tuple(cfg["vocoder"]["upsample_scales"]))
    return Config(audio=AudioConfig(**cfg["audio"]), vae=VAEConfig(**cfg["vae"]),
                  vocoder=VocoderConfig(**voc))


class RecordedVocoder:
    """The vocoder handed to the service: ``.batch`` runs the program's
    vocoder inside a harness span and keeps each drain's mels and outputs
    for the judge.  While ``warming`` is set it returns silence at once,
    records nothing and leaves the sampler, warmed on its own, alone."""

    def __init__(self, batch_fn, spans: Spans, chunk_frames: int, hop: int, alter: bool = False,
                 after=None):
        self._batch, self._spans, self._alter, self._after = batch_fn, spans, alter, after
        self._chunk, self._hop = chunk_frames, hop
        self.drains: list[dict] = []
        self.warming = False

    def batch(self, mels):
        if self.warming:
            return [np.zeros(m.shape[1] * self._hop, np.float32) for m in mels]
        frames = max(m.shape[1] for m in mels)
        chunks = sum(m.shape[1] // self._chunk for m in mels)
        with self._spans.span("vocoder.batch", rows=len(mels), frames=frames,
                              chunks=chunks) as s:
            t0 = time.perf_counter()
            outs = self._batch(mels)
            s["seconds"] = time.perf_counter() - t0
        if self._after is not None:
            self._after()
        if self._alter and not self.drains:  # the fault: an answer altered where it is made
            outs = list(outs)
            w = outs[0].copy()
            mid = len(w) // 2
            w[mid:mid + 256] *= 0.5
            outs[0] = w
        self.drains.append({"mels": [np.array(m, np.float32) for m in mels], "outs": outs,
                            "frames": frames})
        return outs


def _control_batch(voc_model, seed, dev):
    """The program's int8 sampler path (``generate(..., quantize_int8=True)``)
    batched as make_vocoder batches: the next lower precision below bf16."""
    from dvc_tpu_torch.kernels.wavenet_step import generate

    def batch(mels):
        ts = [m.shape[1] for m in mels]
        bucket = -(-max(ts) // 32) * 32
        c = np.zeros((len(mels), bucket, mels[0].shape[0]), np.float32)
        for i, m in enumerate(mels):
            c[i, :m.shape[1]] = m.T
        wavs = generate(voc_model, c, seed, weight_dtype=torch.bfloat16, quantize_int8=True,
                        device=dev).cpu().numpy()
        return [wavs[i, :t * voc_model.hop] for i, t in enumerate(ts)]
    return batch


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def run(ctx) -> common.Outcome:
    root = common.scratch_dir("serve")
    try:
        return _run(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, root: str) -> common.Outcome:
    from dvc_tpu_torch.convert.vocode import make_vocoder
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.ops.audio import resample_poly
    from dvc_tpu_torch.ops.mel import melspectrogram
    from dvc_tpu_torch.serve import ConversionService, make_http_server

    cfg, tr, st = ctx.config, ctx.traffic, ctx.settings
    audio, vae, voc = cfg["audio"], cfg["vae"], cfg["vocoder"]
    dev = torch.device(ctx.device)
    seeds = common.sub_seeds(ctx.seed, SEEDS)
    spans = Spans()
    pcfg = program_config(cfg)
    lap = common.Laps(ctx.t_start)
    lap("start")

    sd_vae = vae_state_dict(vae, seeds["vae"], dev)
    sd_voc = vocoder_state_dict(voc, seeds["voc"], dev)
    with torch.device("meta"):
        model = DisentangledVAE(pcfg.vae)
    model = model.to_empty(device=dev)
    model.load_state_dict(sd_vae)
    vocoder = make_vocoder(None, pcfg.vocoder, seed=seeds["voc_seed"], variables=sd_voc,
                           device=dev)
    lap("weights")
    after = None
    batch_fn = vocoder.batch
    if ctx.variant == "control":
        from dvc_tpu_torch.models.wavenet import WaveNet
        vm = WaveNet(pcfg.vocoder)
        vm.load_state_dict(sd_voc)
        batch_fn = _control_batch(vm.to(dev).eval(), seeds["voc_seed"], dev)
        after = _tf32_on
    rec = RecordedVocoder(batch_fn, spans, vae["frames"], int(np.prod(voc["upsample_scales"])),
                          alter=ctx.variant == "altered", after=after)

    speakers = corpus.speaker_mels(root, audio, tr["speakers"], tr["speaker_files"],
                                   tr["speaker_seconds"], seeds["speakers"], dev)
    service = ConversionService(pcfg, model, root, vocoder=rec,
                                max_batch_chunks=st["max_batch_chunks"],
                                max_wait_ms=st["max_wait_ms"], device=dev)
    if after is not None:
        after()
    lap("speakers_and_service")

    # the requests: a fixed set of lengths a round, dealt to the clients in
    # an order drawn from the seed
    lengths = corpus.stratified_lengths(tr["set_size"], tr["median_s"], tr["sigma"],
                                        tr["min_s"], tr["max_s"])
    rng = np.random.default_rng(seeds["order"])
    n_cl, per_cl = tr["clients"], tr["requests_per_client"]
    stream = np.concatenate([rng.permutation(len(lengths))
                             for _ in range(-(-n_cl * per_cl // len(lengths)))])
    sr = tr["sample_rate"]
    plan = []
    for i in range(n_cl):
        idx = stream[i::n_cl][:per_cl]
        spk = rng.integers(0, len(speakers), len(idx))
        wavs = corpus.speech([int(lengths[j] * sr) for j in idx], sr,
                             common.derive(seeds["bodies"], i), dev)
        plan.append([(corpus.pcm16_wav(w, sr), speakers[s]) for w, s in zip(wavs, spk)])

    lap("request_bodies")
    # warm-up: the styles, the VAE's chunk buckets, the front end at every
    # request length, and the sampler at the clients' batch
    with torch.inference_mode():
        for s in speakers:
            service.target_style(s)
        nb = 1
        while nb <= 2 * st["max_batch_chunks"]:
            service._convert(torch.zeros(nb, vae["num_mels"], vae["frames"], device=dev),
                             torch.zeros(nb, vae["speaker_size"], device=dev))
            nb *= 2
        for n in sorted({int(x * sr) for x in lengths}):
            x = resample_poly(torch.zeros(n, device=dev), sr, audio["sample_rate"])
            melspectrogram(torch.nn.functional.pad(x, (0, _bucket(x.shape[-1]) - x.shape[-1])),
                           pcfg.audio)
    batch_fn([np.zeros((vae["num_mels"], 32), np.float32)] * min(n_cl, st["max_batch_chunks"]))
    if after is not None:
        after()
    lap("warm_up")
    server = make_http_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    rec.warming = True
    warm_round(port, [p[0] for p in plan])
    rec.warming = False
    lap("http_warm_round")
    inner_submit = service.submit

    def submit(payload, trg_spk, timeout=120.0):  # the queue's side of each request
        with spans.span("serve.submit", frames=int(payload.shape[1])):
            return inner_submit(payload, trg_spk, timeout)
    service.submit = submit
    clients = subprocess.Popen([sys.executable, str(common.BENCH_DIR / "loadgen.py")],
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        pickle.dump({"port": port, "seconds": ctx.seconds,
                     "plan": plan}, clients.stdin)
        clients.stdin.flush()
        if clients.stdout.readline().strip() != b"ready":
            raise RuntimeError("the load generator did not start")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)

        # the window
        trace = DeviceTrace() if ctx.trace else None
        stats0 = dict(service.stats)
        if trace is not None:
            trace.start()
        t_w0 = time.perf_counter()
        m_w0 = time.monotonic()
        wall0 = time.time_ns()
        setup_s = t_w0 - ctx.t_start
        clients.stdin.write(f"go {m_w0!r}\n".encode())
        clients.stdin.flush()
        results = pickle.load(clients.stdout)
        if clients.wait(timeout=60) != 0:
            raise RuntimeError(f"the load generator exited with {clients.returncode}")
    finally:
        if clients.poll() is None:
            clients.kill()
            clients.wait()
    for r in results:  # onto this process's window clock
        r["t0"], r["t1"] = t_w0 + (r["t0"] - m_w0), t_w0 + (r["t1"] - m_w0)
        r["body"] = plan[r["client"]][r["body_index"]][0]
    t_last = max(r["t1"] for r in results)
    wall1 = wall0 + int((t_last - t_w0) * 1e9)
    if trace is not None:
        trace.stop()
    stats1 = dict(service.stats)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    server.shutdown()
    server.server_close()
    srv.join(timeout=30)

    # end-to-end metrics
    window = t_last - t_w0
    audio_s = 0.0
    lat = []
    for r in results:
        if r["ok"]:
            pcm, rate = ref_audio.pcm16_of(r["reply"])
            audio_s += len(pcm) / rate
        lat.append(r["t1"] - r["t0"] if r["ok"] else float("inf"))
    lat.sort()
    p95 = lat[max(0, int(np.ceil(0.95 * len(lat))) - 1)]
    failed = sum(not r["ok"] for r in results)
    e2e = {"audio_s_per_s": audio_s / window, "latency_p95_s": p95 if np.isfinite(p95) else 1e12,
           "setup_s": setup_s}

    spans.items += [{"name": "client.request", "tid": -1, "t0": wall0 + int((r["t0"] - t_w0) * 1e9),
                     "t1": wall0 + int((r["t1"] - t_w0) * 1e9)} for r in results]
    records = {"spans": spans.items, "window_ns": (wall0, wall1), "window_s": window,
               "trace_window_ns": (wall0, wall1),
               "counters": {k: stats1[k] - stats0[k] for k in stats0},
               "config": cfg, "trace": trace}
    del model, service, vocoder
    checks = judge(ctx, results, rec, sd_vae, sd_voc, speakers, root, seeds, failed)
    return common.Outcome(attempted=len(results), failed=failed, end_to_end=e2e,
                          memory_peak_bytes=int(peak), checks=checks, records=records,
                          notes=dict(lap.items, drains=drain_arrivals(spans.items),
                                     connect_max_s=max((round(r["connect_s"], 4) for r in results
                                                        if r["ok"]), default=None)))


def drain_arrivals(spans: list[dict]) -> list[list]:
    """For each ``.batch`` call: its rows, and the milliseconds from the
    previous call's end to the first request that reached the queue for
    it and from that request to the last (the spread of a round's
    arrivals, which the service's ``max_wait_ms`` has to cover)."""
    subs = sorted(s["t0"] for s in spans if s["name"] == "serve.submit")
    out, prev = [], None
    for b in sorted((s for s in spans if s["name"] == "vocoder.batch"), key=lambda s: s["t0"]):
        mine = [t for t in subs if (prev is None or t > prev) and t <= b["t0"]]
        if mine:
            out.append([b["rows"], round(((mine[0] - prev) if prev else 0) / 1e6, 1),
                        round((mine[-1] - mine[0]) / 1e6, 1)])
        prev = b["t1"]
    return out


def warm_round(port: int, firsts: list) -> None:
    """The clients' first requests, sent at once through the HTTP path
    (each request a new server thread, as in the window), so that the
    per-thread state the front end's library calls keep (cuDNN and cuBLAS
    handles, which a thread hands back when it ends) is there for as many
    threads as the window's rounds run at once."""
    import http.client
    status = []

    def post(body, spk):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", f"/convert?trg_spk={spk}", body, {"Content-Type": "audio/wav"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            status.append(resp.status)
        except (OSError, http.client.HTTPException) as e:
            status.append(repr(e))
    threads = [threading.Thread(target=post, args=f) for f in firsts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(x != 200 for x in status):
        raise RuntimeError(f"the warm-up round failed: {status}")


def judge(ctx, results, rec, sd_vae, sd_voc, speakers, root, seeds, failed) -> list[common.Check]:
    """The served answers against the plain reference (module docstring)."""
    cfg, st = ctx.config, ctx.settings
    audio, vae, voc = cfg["audio"], cfg["vae"], cfg["vocoder"]
    dev = torch.device(ctx.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lim = st["limits"]
    by_reply = {}
    for d, drain in enumerate(rec.drains):
        for row, out in enumerate(drain["outs"]):
            by_reply[hashlib.sha1(ref_audio.wav_bytes(out, audio["sample_rate"])).digest()] = (d, row)
    done = [r for r in results if r["ok"]]
    unmatched = [r for r in done if hashlib.sha1(r["reply"]).digest() not in by_reply]
    matched = [r for r in done if hashlib.sha1(r["reply"]).digest() in by_reply]
    rng = np.random.default_rng(seeds["judge"])
    picked = []
    if matched:
        longest = max(range(len(matched)), key=lambda i: len(matched[i]["reply"]))
        rest = [i for i in range(len(matched)) if i != longest]
        rng.shuffle(rest)
        picked = [matched[i] for i in [longest] + rest[:st["judge_requests"] - 1]]

    m = ref_vae.on_device(vae, sd_vae, dev)
    styles = {}
    mel_err, sq_cfg, sq_low = 0.0, 0.0, 0.0
    # the served precision and the next lower one
    cfg_w, low_w = ("bfloat16", "int8") if dev.type == "cuda" else ("float32", "bfloat16")
    nr = voc["out_channels"] // 3
    for r in picked:
        d, row = by_reply[hashlib.sha1(r["reply"]).digest()]
        drain = rec.drains[d]
        spk = r["spk"]
        if spk not in styles:
            ch = [ref_audio.chunk(torch.from_numpy(np.load(fp)).to(dev), vae["frames"])
                  for fp in sorted(glob.glob(os.path.join(root, spk, "*.npy")))]
            styles[spk] = ref_vae.target_style(m, torch.cat(ch))
        pcm, sr = ref_audio.pcm16_of(r["body"])
        mel = ref_audio.front_end(pcm.astype(np.float32) / 32768.0, sr, audio, dev)
        conv = ref_vae.convert(m, ref_audio.chunk(mel, vae["frames"]), styles[spk])
        conv = conv.permute(1, 0, 2).reshape(conv.shape[1], -1)            # (n_mels, frames)
        got = torch.from_numpy(drain["mels"][row]).to(dev)
        mel_err = max(mel_err, (got - conv).abs().max().item()) if got.shape == conv.shape \
            else float("inf")
        # the vocoder is judged on the mel it was given, which mel_err judges
        served = torch.from_numpy(np.asarray(drain["outs"][row], np.float32)).to(dev)
        frames = torch.zeros(1, drain["frames"], vae["num_mels"], device=dev)
        frames[0, :got.shape[1]] = got.T
        if dev.type == "cuda":
            gum, u = ref_wn.uniforms(seeds["voc_seed"], row, served.shape[0], nr)
        else:
            gum, u = ref_wn.cpu_stream_uniforms(seeds["voc_seed"], len(drain["outs"]),
                                                served.shape[0], nr)
            gum, u = gum[:, row], u[:, row]
        with torch.no_grad():
            cond = ref_wn.upsample(sd_voc, voc, frames)[0, :served.shape[0]]
            y_cfg = ref_wn.teacher_forced(sd_voc, voc, cond, served, cfg_w)
            y_low = ref_wn.teacher_forced(sd_voc, voc, cond, served, low_w)
        lsm = voc["log_scale_min"]
        sq_cfg += float(np.sum(ref_wn.judge_draws(y_cfg, served, gum, u, lsm) ** 2))
        sq_low += float(np.sum(ref_wn.judge_draws(y_low, served, gum, u, lsm) ** 2))
    ratio = sq_cfg / sq_low if picked and sq_low > 0 else float("inf")
    return [common.Check("failed_requests", float(failed), 0.0),
            common.Check("reply_mismatch", float(len(unmatched)), 0.0),
            common.Check("mel_err", float(mel_err), lim["mel_err"]),
            common.Check("draw_ratio", float(ratio), lim["draw_ratio"])]
