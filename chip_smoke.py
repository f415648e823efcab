#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (dvc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before a result line is printed:
  1. build  every kernel under dvc_tpu_torch/kernels/csrc, one nvcc each,
            all started together;
  2. kernel the WaveNet sampler kernel against its plain PyTorch version at
            the full VocoderConfig width (24 layers, 512 channels), under the
            doctored deterministic head (mixture 0 dominates, log scales
            pinned at -40, its mean scaled so the trajectory moves: std
            above 0.05 here, above 0.02 at the main path's shapes): B in
            {1, 4}, T = 1024, float32 weights (atol 5e-5) and bf16 weights
            (atol 0.05); two corrupted weight packs (a wrong ring tap, a
            dropped residual) that the float32 limit must reject;
            the stochastic mode (finite, in [-1, 1], seeded: repeatable,
            different per seed); the kernel's MoL sampler alone against
            sample_from_mol's moments;
  3. main   the serving path at full width: a synthetic 2-speaker mel corpus
            made with the port's melspectrogram, a full-size DisentangledVAE
            and WaveNet from seeded random weights, the HTTP server with the
            CUDA vocoder, and 3 concurrent POST /convert of 0.5 s wavs; the
            VAE on the card against the same VAE on the CPU;
  4. shapes the kernel against its plain version at the shapes the main path
            gave it, float32 and bf16 weights at the limits above, timed with
            CUDA events.
The lines before the last report the card (nvidia-smi name and power limit),
timings and one JSON line of kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor-core peak
              torch.float32: 67e12}    # float32 outside the tensor cores
F32_ATOL = 5e-5    # float32 sums in another order over 1616-term dots: ~10x
                   # the error measured (PERF.md), far below the corrupted packs'
BF16_ATOL = 0.05   # bf16 roundings of h, the gate and the skip flip by one ulp
                   # where the sum order differs; the head's gain turns that
                   # into ~0.3 of the trajectory's std (PERF.md), as it does
                   # any other small change: float32 is the fine check
TRAJ_STD = 0.05    # the doctored trajectory's spread, set by doctor_head and
                   # required at T = 1024, start-up transient included
MAIN_STD = 0.02    # required over the main path's 16,384 steps, where the
                   # steady trajectory, which moves less, dominates
SEED = 0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[0]


def events_ms(fn):
    """(result, milliseconds) of fn() between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def seeded(build, seed):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def doctor_head(model):
    """Deterministic MoL head: mixture 0 always wins, scales e^-40 (the
    doctored head of tests/test_pallas_wavenet.py:26-44).  Mixture 0's mean
    row is then centred and scaled so that, over a teacher-forced pass of
    random frames, it has mean 0 and std TRAJ_STD: at random init the raw
    mean is a near-constant offset that no check could tell from a wrong
    trajectory."""
    nr = model.cfg.out_channels // 3
    dev = next(model.parameters()).device
    with torch.no_grad():
        f2 = model.last_conv_layers[3]
        f2.weight[:nr] = 0.0
        f2.weight[2 * nr:] = 0.0
        f2.bias[:nr] = -10.0
        f2.bias[0] = 10.0
        f2.bias[2 * nr:] = -40.0
        f2.weight[nr:2 * nr] *= 20.0
        g = torch.Generator(device=dev).manual_seed(99)
        frames = torch.rand(2, 16, model.cfg.cin_channels, device=dev, generator=g)
        x = torch.zeros(2, 16 * model.hop, 1, device=dev)
        mean0 = model(x, frames)[..., nr] - f2.bias[nr]
        k = TRAJ_STD / mean0.std().item()
        f2.weight[nr] *= k
        f2.bias[nr] = -k * mean0.mean()
    return model


def corrupted(packed):
    """Packs the kernel must not pass for the plain pack: layer 3 reads its
    taps at half its dilation; layer 10 drops its residual output."""
    wrong_tap = dict(packed, dil=packed["dil"].copy())
    wrong_tap["dil"][3] //= 2
    no_res = dict(packed, w_so=packed["w_so"].clone())
    no_res["w_so"][10, packed["cfg"].skip_out_channels:] = 0
    return {"wrong tap": wrong_tap, "dropped residual": no_res}


def bound(packed, cond):
    """(bound_ms, bound_by): the larger of moving every input once and the
    output once at the memory rate, and the multiply-adds at the peak rate
    of the weight dtype."""
    c = packed["cfg"]
    L, R, G, S = c.layers, c.residual_channels, c.gate_channels, c.skip_out_channels
    C, K = c.cin_channels, c.out_channels
    b, t, _ = cond.shape
    nbytes = sum(v.numel() * v.element_size() for v in packed.values()
                 if isinstance(v, torch.Tensor))
    nbytes += cond.numel() * 4 + b * t * 4
    macs = L * (G * (3 * R + C) + (S + R) * (G // 2)) + S * S + K * S
    flops = 2.0 * macs * b * t
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[packed["w_in"].dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def stream_us(packed) -> float:
    """Microseconds to stream every packed weight from device memory once:
    the per-sample-step floor of a kernel that keeps no weight on chip."""
    nbytes = sum(v.numel() * v.element_size() for v in packed.values()
                 if isinstance(v, torch.Tensor))
    return nbytes / HBM_BYTES_PER_S * 1e6


def check(cond_ok: bool, what: str):
    if not cond_ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    from dvc_tpu_torch.config import AudioConfig, Config, VAEConfig, VocoderConfig
    from dvc_tpu_torch.convert.conversion import convert_mel
    from dvc_tpu_torch.convert.vocode import make_vocoder
    from dvc_tpu_torch.kernels import _build
    from dvc_tpu_torch.kernels import wavenet_step as ws
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.models.wavenet import WaveNet, sample_from_mol
    from dvc_tpu_torch.ops.mel import melspectrogram
    from dvc_tpu_torch.serve import ConversionService, make_http_server
    from dvc_tpu_torch.utils.device import use_exact_float32
    from dvc_tpu_torch.utils.wavio import parse_wav, wav_bytes

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    use_exact_float32()
    card = card_line()
    print(f"card: {card}", flush=True)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s wall)", flush=True)

    # 2. kernel vs plain at full width ------------------------------------------
    vcfg = VocoderConfig()
    det = doctor_head(seeded(lambda: WaveNet(vcfg), SEED + 1).to(dev).eval())
    for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        packed = ws.pack_wavenet_params(det, dtype, dev)
        for b in (1, 4):
            g = torch.Generator(device=dev).manual_seed(10 + b)
            frames = torch.rand(b, 1024 // det.hop, vcfg.cin_channels, device=dev, generator=g)
            with torch.inference_mode():
                cond = det.upsample(frames).contiguous()
            t = cond.shape[1]
            kern, k_ms = events_ms(lambda: ws.wavenet_generate(packed, cond, 0, True))
            plain, p_ms = events_ms(lambda: ws.wavenet_generate_plain(packed, cond, 0, True))
            _, k_ms = events_ms(lambda: ws.wavenet_generate(packed, cond, 0, True))
            err = (kern - plain).abs().max().item()
            name = str(dtype).replace("torch.", "")
            print(f"kernel vs plain [{card}] {name} B={b} T={t}: max_abs_err {err:.3e} "
                  f"(atol {atol}); trajectory std {plain.std().item():.4f}; "
                  f"kernel {k_ms * 1e3 / t:.1f} us/sample-step, plain "
                  f"{p_ms * 1e3 / t:.1f} us/sample-step, HBM-streaming bound "
                  f"{stream_us(packed):.1f} us", flush=True)
            check(math.isfinite(err) and err <= atol, f"{name} B={b} kernel vs plain {err}")
            check(plain.std().item() > TRAJ_STD, "doctored trajectory does not move")
        for what, bad in corrupted(packed).items():
            bad_err = (ws.wavenet_generate(bad, cond, 0, True) - plain).abs().max().item()
            print(f"corrupted pack [{name} B={b}] {what}: max_abs_err {bad_err:.3e} "
                  f"(atol {atol})", flush=True)
            if dtype == torch.float32:
                check(bad_err > atol, f"the float32 check passes a pack with a {what}")

    rnd = seeded(lambda: WaveNet(vcfg), SEED + 2).to(dev).eval()
    packed = ws.pack_wavenet_params(rnd, torch.bfloat16, dev)
    s1 = ws.wavenet_generate(packed, cond, 1)
    s1b = ws.wavenet_generate(packed, cond, 1)
    s2 = ws.wavenet_generate(packed, cond, 2)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(s1).all()) and s1.abs().max().item() <= 1.0,
          "stochastic output not finite in [-1, 1]")
    check(torch.equal(s1, s1b), "same seed, different samples")
    check(not torch.equal(s1, s2), "different seeds, same samples")
    print("stochastic mode: finite in [-1, 1], repeatable per seed, seeds differ", flush=True)

    nr = vcfg.out_channels // 3
    means = torch.linspace(-0.9, 0.9, nr)
    logits = torch.randn(nr, generator=torch.Generator().manual_seed(5))
    y = torch.cat([logits, means, torch.full((nr,), -6.0)]).to(dev)
    n = 200_000
    k_draws = ws.mol_sample(y.expand(n, -1), seed=3)
    p_draws = sample_from_mol(y.expand(n, -1), torch.Generator(device=dev).manual_seed(3))
    soft = torch.softmax(logits, 0).to(dev)
    for draws, who in ((k_draws, "kernel"), (p_draws, "plain")):
        freq = torch.bincount((draws[:, None] - means.to(dev)).abs().argmin(1),
                              minlength=nr).float() / n
        check((freq - soft).abs().max().item() < 0.01, f"{who} MoL mixture frequencies")
    d_mean = abs(k_draws.mean().item() - p_draws.mean().item())
    d_std = abs(k_draws.std().item() - p_draws.std().item())
    print(f"MoL sampler alone: {n} draws, |mean diff| {d_mean:.2e}, |std diff| {d_std:.2e}",
          flush=True)
    check(d_mean < 0.01 and d_std < 0.01, "MoL sampler moments")

    # 3. the main path ------------------------------------------------------------
    acfg = AudioConfig()
    cfg = Config(vae=VAEConfig())
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    mel_dir = os.path.join(tmp.name, "mels")
    for si, spk in enumerate(("spkA", "spkB")):
        os.makedirs(os.path.join(mel_dir, spk))
        for ui in range(2):
            tt = np.arange(acfg.sample_rate) / acfg.sample_rate
            wav = 0.4 * np.sin(2 * np.pi * (140 + 90 * si + 25 * ui) * tt)
            with torch.inference_mode():
                mel = melspectrogram(torch.tensor(wav, dtype=torch.float32, device=dev), acfg)
            np.save(os.path.join(mel_dir, spk, f"{spk}_{ui:03d}_mel.npy"), mel.cpu().numpy())

    vae = seeded(lambda: DisentangledVAE(cfg.vae), SEED + 3).eval()
    src = np.load(os.path.join(mel_dir, "spkA", "spkA_000_mel.npy"))
    trg = np.load(os.path.join(mel_dir, "spkB", "spkB_000_mel.npy"))
    want = convert_mel(vae, src, trg)
    vae = vae.to(dev)
    got = convert_mel(vae, src, trg)
    vae_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"VAE on the card vs on the CPU (full width, float32): max_abs_err {vae_err:.3e}",
          flush=True)
    check(vae_err <= 1e-3, "VAE on the card disagrees with the CPU")

    wavenet_sd = seeded(lambda: WaveNet(vcfg), SEED + 4).state_dict()
    voc = make_vocoder(None, vcfg, seed=SEED, variables=wavenet_sd, device=dev)
    seen = []

    def voc_batch(mels):
        wavs = voc.batch(mels)
        seen.append(([m.shape for m in mels],
                     all(np.isfinite(w).all() and np.abs(w).max() <= 1.0 for w in wavs)))
        return wavs

    def vocoder(mel):
        return voc_batch([mel])[0]

    vocoder.batch = voc_batch
    service = ConversionService(cfg, vae, mel_dir, vocoder=vocoder,
                                max_wait_ms=1000.0, device=dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_http_server(service, "127.0.0.1", port)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    url = f"http://127.0.0.1:{port}"

    def post(seed):
        rng = np.random.RandomState(seed)
        tt = np.arange(acfg.sample_rate // 2) / acfg.sample_rate
        wav = (0.3 * np.sin(2 * np.pi * (160 + 20 * seed) * tt)
               + 0.01 * rng.randn(len(tt))).astype(np.float32)
        req = urllib.request.Request(f"{url}/convert?trg_spk=spkB",
                                     data=wav_bytes(wav), method="POST")
        t_req = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body = r.read()
            status = r.status
        return status, body, time.perf_counter() - t_req

    try:
        post(100)  # warm-up: cuDNN plans, the kernel library, the weight pack
        with service._stats_lock:
            before = dict(service.stats)
        seen.clear()
        ws.wavenet_generate.launches = 0
        ws.mol_sample.launches = 0
        t_main = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(post, (1, 2, 3)))
        main_s = time.perf_counter() - t_main
        launches = ws.wavenet_generate.launches
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        srv_thread.join(timeout=30)

    hop = int(np.prod(vcfg.upsample_scales))
    for status, body, _ in replies:
        wav, sr = parse_wav(body)
        check(status == 200 and sr == acfg.sample_rate, "reply status/sample rate")
        check(wav.shape == (64 * hop,) and np.isfinite(wav).all(), f"reply wav {wav.shape}")
    check(all(ok for _, ok in seen), "vocoder output not finite in [-1, 1]")
    d_req = stats["requests"] - before["requests"]
    d_bat = stats["batches"] - before["batches"]
    check(d_req == 3 and d_bat < d_req, f"no batching: {d_req} requests in {d_bat} batches")
    check(launches > 0, "the main path did not launch the CUDA kernel")
    lat = sorted(r[2] for r in replies)
    print(f"main path [{card}]: 3 concurrent POST /convert (0.5 s wav -> {64 * hop} samples) "
          f"in {main_s:.2f} s; request latency min {lat[0]:.2f} s, max {lat[-1]:.2f} s; "
          f"{d_req} requests in {d_bat} batch(es); wavenet_generate launches {launches}",
          flush=True)

    # 4. the kernel at the main path's shapes -----------------------------------
    shapes = max((s for s, _ in seen), key=len)
    b_main = len(shapes)
    f_main = -(-max(s[1] for s in shapes) // 32) * 32     # make_vocoder's frame bucket
    g = torch.Generator(device=dev).manual_seed(20)
    frames = torch.rand(b_main, f_main, vcfg.cin_channels, device=dev, generator=g)
    with torch.inference_mode():
        cond = det.upsample(frames).contiguous()
    # float32 first (the fine check), then bf16: the main path's weights,
    # whose numbers go into the report
    for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        packed = ws.pack_wavenet_params(det, dtype, dev)
        kern, _ = events_ms(lambda: ws.wavenet_generate(packed, cond, 0, True))
        _, k_ms = events_ms(lambda: ws.wavenet_generate(packed, cond, 0, True))
        plain, p_ms = events_ms(lambda: ws.wavenet_generate_plain(packed, cond, 0, True))
        err = (kern - plain).abs().max().item()
        b_ms, b_by = bound(packed, cond)
        name = str(dtype).replace("torch.", "")
        print(f"kernel at main-path shapes [{card}] cond {tuple(cond.shape)} {name}: "
              f"{k_ms:.1f} ms ({k_ms * 1e3 / cond.shape[1]:.1f} us/sample-step), plain "
              f"{p_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), max_abs_err {err:.3e} "
              f"(atol {atol}); trajectory std {plain.std().item():.4f}", flush=True)
        check(math.isfinite(err) and err <= atol, f"main-shape {name} kernel vs plain {err}")
        check(plain.std().item() > MAIN_STD, "doctored trajectory does not move")
    tmp.cleanup()

    # 5. where the kernel's time goes: device time by kernel, device idle share
    short = cond[:1, :256].contiguous()
    ws.wavenet_generate(packed, short, 0, True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, prof_ms = events_ms(lambda: ws.wavenet_generate(packed, short, 0, True))
    steps = short.shape[1]
    by_kernel = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        for part in ("layer_in", "layer_out", "final1", "head", "init_h", "Memset"):
            if dev_us > 0 and part in e.key:
                n_, us_ = by_kernel.get(part, (0, 0.0))
                by_kernel[part] = (n_ + e.count, us_ + dev_us)
    busy_us = sum(us for _, us in by_kernel.values())
    if busy_us > 0:
        parts = ", ".join(f"{k} {us / n:.2f} us x {n // steps}/step"
                          for k, (n, us) in by_kernel.items() if n >= steps)
        print(f"profile [{card}] B=1 T={steps} bf16: {prof_ms * 1e3 / steps:.1f} us/sample-step "
              f"wall, device busy {busy_us / steps:.1f} us/step "
              f"(idle share {1 - busy_us / (prof_ms * 1e3):.3f}); {parts}", flush=True)
    else:
        print(f"profile [{card}]: the profiler recorded no device time (not measured)",
              flush=True)

    report = {"kernels": [{
        "name": "wavenet_generate",
        "route": "cuda",
        "source": "dvc_tpu_torch/kernels/csrc/wavenet_step.cu",
        "replaces": "dvc_tpu/kernels/wavenet_step.py:415",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes AR generation
    }]}
    print(json.dumps(report), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
