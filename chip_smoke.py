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
            dropped residual) that the float32 limit must reject; float32
            at B = 9, T = 256, across the row tile of 8 (atol 5e-5);
            the stochastic mode (finite, in [-1, 1], seeded: repeatable,
            different per seed; every block of the persistent kernel drew
            the same samples); the kernel's MoL sampler alone against
            sample_from_mol's moments;
  3. main   the serving path at full width: a synthetic 2-speaker mel corpus
            made with the port's melspectrogram, a full-size DisentangledVAE
            and WaveNet from seeded random weights, the HTTP server with the
            CUDA vocoder, and 3 concurrent POST /convert of 0.5 s wavs; the
            VAE on the card against the same VAE on the CPU;
  4. shapes the kernel against its plain version at the shapes the main path
            gave it, float32 and bf16 weights at the limits above (every
            block's draws equal; the timed call's output is the one
            compared, and equals the check run's), timed with CUDA events;
  5. plan    each dtype's block plan (blocks, rows a block, row tile,
            resident layers and bytes) and the barrier floor; us per sample
            step for bf16 and int8 at B in {1, 3, 4, 8}, beside the per-launch
            design's; the share of each phase in block 0's cycles;
  6. int8   int8 weight streaming (the port of the TPU's quantized streamed
            kernel): (i) the fine check at a narrow width (8 layers, 64
            channels, final1 in float32, first_conv zeroed so the sampled
            output is not fed back) against the plain version, B = 4,
            T = 1024, with a pack whose tap scales are swapped in one layer
            rejected; (ii) the coarse check at full width, B in {1, 4},
            T = 1024 (atol 0.05), with the same swap in every layer
            reported; (iii) stochastic mode (every block's draws equal);
            (iv) its main path, generate(..., quantize_int8=True) on 3 x 64
            mel frames at full width, timed, launches counted; (v) the
            kernel against its plain version at that path's shape, full
            width, with first_conv zeroed as in (i): the int8 pack with
            final1 in float32 against the plain version, with packs whose
            scales are wrong rejected; the bf16 pack and generate's int8
            pack (bf16 final1), the packs the main paths run, against the
            open-loop plain version (all steps at once, itself held to the
            plain version on the first pack), every block's draws equal,
            with packs with a wrong ring tap, zeroed skip/out rows or
            final1's skip inputs reversed rejected; (vi) the profiler's
            records of one bf16 and one int8 main-path generate call:
            exactly one sampling-kernel launch each, its device time and
            the idle share;
  7. probes the tools/ Pallas probes as CUDA kernels (dvc_tpu_torch.tools):
            P1 bench_taps (modes dynamic, static, compute), P2 resident and
            P3 streamed bench_body, P4 bench_body2 (stages 0-4). (i) their
            main path: each entry point's bench at its probe's constants
            (B = 8, R = 512, T = 2000 or 1000, 24 layers), launches counted;
            (ii) each kernel against its plain twin there, relative to the
            reference's max (float32 1e-4, bf16 5e-3) where the output does
            not underflow; (iii) the checks that can fail, at T = 65, which
            reads every tap (P1 with a weight of larger gain), where a kernel
            with layer 23 at half its dilation (P1 static and compute: a
            zeroed w column), and P2 and P3 with each other's cond rule (also
            at T = 1000), must be rejected.
The lines before the last report the card (nvidia-smi name and power limit),
timings and one JSON line of kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
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
              torch.float32: 67e12,    # float32 outside the tensor cores
              torch.int8: 989e12}      # int8 codes times bf16 activations: bf16
                                       # arithmetic, as dvc_tpu does it (:512-516)
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
INT8_FINE_ATOL = 6e-3  # int8 kernel vs plain at the narrow width, feedback cut:
                       # about twice the error measured, under the error of a
                       # pack with one layer's tap scales swapped (PERF.md)
INT8_FULL_ATOL = 0.013  # the same at full width at the main path's shape: about
INT8_FULL_RMS = 3e-3    # twice the max and rms errors measured; the bf16 noise
                        # there is dense, so the rms holds mid-stack faults (PERF.md)
MAIN_NOFB_ATOL = 0.065  # the bf16 pack and generate's int8 pack (bf16 final1) at
MAIN_NOFB_RMS = 0.0105  # the main path's shape, feedback cut, against the open-loop
                        # plain version: about twice the max and rms errors measured
                        # (bf16 skip sums rounded before final1 flip; PERF.md), under
                        # the rms of layer 12's skip/out rows zeroed
NARROW = dict(layers=8, stacks=2, residual_channels=64, gate_channels=64,
              skip_out_channels=32)  # int8-aligned: R, C = 80 and G/2 whole vectors
SEED = 0
BARRIER_US = 1.14  # one grid barrier on an H100 (tools/ablate_body, PERF.md section 6)
PREV_US = {  # us per sample step of the per-launch design (T x (2L + 2) launches), PERF.md
    ("bfloat16", 1): 322.4, ("bfloat16", 3): 469.5, ("bfloat16", 4): 551.5,
    ("int8", 1): 301.3, ("int8", 3): 424.6, ("int8", 4): 494.0}
PROBE_F32_TOL = 1e-4   # P1, float32, relative to max |ref|: the kernel's other f32 sum
                       # order reads up to 7e-6, corrupted kernels 0.2 and more (PERF.md)
PROBE_BF16_TOL = 5e-3  # P2-P4, bf16 ring and gate, relative to max |ref|: flipped bf16
                       # roundings read up to 2.4e-3, corrupted kernels 1.2e-2 and more
SHORT_T = 65           # probe checks that can fail: reads every tap (2 x 32 + 1)
DECAYED = 1e-12        # max |ref| under which a probe's own output has decayed (P1 at
                       # T = 2000, P4 stage 0 at T = 1000): reported there, held at SHORT_T


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


def swapped_scales(packed, layers):
    """An int8 pack whose tap x_{t-2d} and tap x_{t-d} scales are swapped in
    the given layers: the same codes, wrong per-column weights."""
    bad = dict(packed, s_in=packed["s_in"].clone())
    bad["s_in"][layers, 0] = packed["s_in"][layers, 1]
    bad["s_in"][layers, 1] = packed["s_in"][layers, 0]
    return bad


def int8_corrupted(packed):
    """int8 packs with the right codes and some scales wrong: {name: (pack,
    whether the full-width check must reject it)}.  The legacy skip sum is
    scaled by sqrt(1/2) after every layer, so layer 3's fault reaches the
    head about 2^-10 weaker and hides in the bf16 noise (PERF.md)."""
    def zeroed(key, idx):
        bad = dict(packed, **{key: packed[key].clone()})
        bad[key][idx] = 0
        return bad
    return {"layer 12's s_so zeroed": (zeroed("s_so", 12), True),
            "layer 23's tap x_{t-2d} scales zeroed": (zeroed("s_in", (23, 0)), True),
            "layer 3's s_so zeroed": (zeroed("s_so", 3), False),
            "tap scales swapped in every layer": (swapped_scales(packed, slice(None)), False)}


def nofb_corrupted(packed):
    """Packs that the main-shape check with the feedback cut must reject or
    reports: {name: (pack, whether it must fail)}.  Layer 3's and layer 10's
    faults reach the head scaled down by the legacy sqrt(1/2) skip sum and
    hide in the bf16 noise (PERF.md)."""
    S = packed["cfg"].skip_out_channels
    no_l12 = dict(packed, w_so=packed["w_so"].clone())
    no_l12["w_so"][12] = 0
    no_res = dict(packed, w_so=packed["w_so"].clone())
    no_res["w_so"][10, S:] = 0
    taps = {}
    for li in (23, 3):
        taps[li] = dict(packed, dil=packed["dil"].copy())
        taps[li]["dil"][li] //= 2
    return {"layer 12's skip/out rows zeroed": (no_l12, True),
            "layer 23's ring taps at half its dilation": (taps[23], True),
            "final1's skip inputs reversed": (dict(packed, w_f1=packed["w_f1"].flip(1)), True),
            "layer 10's residual dropped": (no_res, False),
            "layer 3's ring taps at half its dilation": (taps[3], False)}


def bound(packed, cond):
    """(bound_ms, bound_by): the larger of moving every input once (int8
    codes and their scales included) and the output once at the memory
    rate, and the multiply-adds at the peak rate of the weight dtype."""
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


def profile(fn, card, name, steps):
    """One call of fn (a main-path call of the sampler) under torch.profiler:
    the device time of its single wavenet_persistent record, the call's
    wall time and the device's idle share over the call.  Fails unless the
    call made exactly one launch of the sampling kernel."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall_ms = events_ms(fn)
    recs = [e for e in prof.key_averages() if "wavenet_persistent" in e.key]
    n = sum(e.count for e in recs)
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in recs)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    check(n == 1, f"{name}: {n} records of the sampling kernel in one call, not 1")
    if dev_us <= 0:
        print(f"profile [{card}] {name}: 1 kernel record, no device time recorded (not "
              f"measured)", flush=True)
        return
    print(f"profile [{card}] {name}: 1 launch of wavenet_persistent, device time "
          f"{dev_us / 1e3:.1f} ms ({dev_us / steps:.1f} us/sample-step), call wall "
          f"{wall_ms:.1f} ms, device busy {busy_us / 1e3:.1f} ms (idle share "
          f"{1 - busy_us / (wall_ms * 1e3):.3f})", flush=True)


def phase_split(stamps, layers) -> dict[str, float]:
    """Share of block 0's SM cycles by phase over the stamped steps of a
    wavenet_generate_checked call (the first step left out: it also waits
    for the resident weights' copies)."""
    s = stamps[1:].double()
    i = torch.arange(layers, device=s.device) * 4
    end = 4 * layers
    spans = {"in": (i, i + 1), "barrier (a)": (i + 1, i + 2), "out": (i + 2, i + 3),
             "barrier (b)": (i + 3, i + 4), "final1": ([end], [end + 1]),
             "barrier (final1)": ([end + 1], [end + 2]), "head": ([end + 2], [end + 3])}
    cyc = {k: (s[:, b] - s[:, a]).sum().item() for k, (a, b) in spans.items()}
    total = sum(cyc.values())
    return {k: v / total for k, v in cyc.items()}


def check(cond_ok: bool, what: str):
    if not cond_ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 where both are all zero)."""
    d = (got.double() - want.double()).abs().max().item()
    m = want.double().abs().max().item()
    return d / m if m > 0 else (0.0 if d == 0 else math.inf)


def probe_bound(kind, w, B, T, stage=0, layers=24):
    """(bound_ms, bound_by) of a probe run: every input once and the output
    once at the memory rate against the multiply-adds at the peak rate of
    their type (P1 float32; P2-P4 bf16 operands).  P4 reads only the inputs
    its stage uses, and its head only final2's column 0."""
    if kind == "taps":
        r = w.shape[0]
        nbytes = w.numel() * 4 + B * r * 4
        t_ops = 2.0 * layers * B * r * r * T / PEAK_FLOPS[torch.float32]
    else:
        layers, _, r, g = w["w_dil"].shape
        s, c = w["w_skip"].shape[2], w["w_c"].shape[1]
        keys = ["w_dil", "w_c", "w_skip", "w_out"]
        if kind == "body" or stage >= 4:
            keys.append("b" if kind == "body" else "b_dil")
        if kind == "body2" and stage >= 1:
            keys.append("cond_in")
        nbytes = sum(w[k].numel() * w[k].element_size() for k in keys)
        macs = layers * (g * (3 * r + c) + (s + r) * (g // 2))
        if kind == "body2" and stage >= 3:
            nbytes += w["w_first"].numel() * 4 + w["w_f1"].numel() * 2 + s * 4
            macs += s * s + s
        nbytes += (T * B if kind == "body2" and stage >= 2 else B * r) * 4
        t_ops = 2.0 * macs * B * T / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def probe_profile(pb, w, dil, B, card, steps=50):
    """Where P3's time goes: device time of its two kernels (the phases
    that P2 runs between grid barriers) and the device's idle share over one
    streamed call of `steps` steps, by torch.profiler."""
    layers = len(dil)
    want = {"body_in": layers * steps, "body_out": layers * steps}
    pb.streamed(w, B=B, T=steps, dil=dil)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, ms = events_ms(lambda: pb.streamed(w, B=B, T=steps, dil=dil))
    by_kernel = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        for part in want:
            if dev_us > 0 and part in e.key:
                n_, us_ = by_kernel.get(part, (0, 0.0))
                by_kernel[part] = (n_ + e.count, us_ + dev_us)
    if set(by_kernel) != set(want):
        print(f"profile P3 [{card}]: the profiler recorded no device time (not measured)",
              flush=True)
        return
    busy_us = sum(us for _, us in by_kernel.values())
    parts = ", ".join(f"{k} {us / n:.2f} us x {n}/{want[k]}" for k, (n, us) in by_kernel.items())
    print(f"profile P3 [{card}] B={B} T={steps}: {ms * 1e3 / steps:.1f} us/sample wall, device "
          f"busy {busy_us / steps:.1f} us/step (idle share {1 - busy_us / (ms * 1e3):.3f}); "
          f"{parts}", flush=True)


def probes(card, dev):
    """Phase 7: the tools/ probes P1-P4 as CUDA kernels.  (i) their main
    path, each entry point's bench at the probe's constants, counted; (ii)
    each kernel against its plain twin at those constants; (iii) the checks
    that can fail, at T = SHORT_T, which reads every ring tap, where the
    probes' own outputs are alive, with corrupted variants that must be
    rejected.  Returns the kernels' report entries."""
    from dvc_tpu_torch.tools import _common
    from dvc_tpu_torch.tools import bench_body as pb
    from dvc_tpu_torch.tools import bench_body2 as p4
    from dvc_tpu_torch.tools import bench_taps as p1

    B = p1.B
    # (i) the main path: every entry point once, counts from 0
    p1.taps.launches.clear()
    pb.resident.launches = pb.streamed.launches = 0
    p4.body2.launches.clear()
    t_main = time.perf_counter()
    timed = {("taps", m): p1.bench(m, device=dev) for m in p1.MODES}
    timed[("resident", None)] = pb.bench("resident", pb.make_resident(device=dev), device=dev)
    timed[("streamed", None)] = pb.bench("streamed", pb.make_streamed(device=dev), device=dev)
    timed.update({("body2", st): p4.bench(st, device=dev) for st in p4.STAGES})
    main_s = time.perf_counter() - t_main
    launches = {("taps", m): p1.taps.launches[m] for m in p1.MODES}
    launches[("resident", None)] = pb.resident.launches
    launches[("streamed", None)] = pb.streamed.launches
    launches.update({("body2", st): p4.body2.launches[st] for st in p4.STAGES})
    counts = json.dumps({f"{k}[{v}]": n for (k, v), n in launches.items()})
    print(f"probes main path [{card}]: every entry point at its probe's constants in "
          f"{main_s:.1f} s; launches {counts}", flush=True)
    for key, n in launches.items():
        check(n > 0, f"the probes' main path did not launch {key}")

    # the weights of the main path, drawn again for the checks
    dil = _common.geometry(p1.LAYERS)[0]
    bad_dil = dil.copy()
    bad_dil[23] //= 2  # the last layer reads its taps at half its dilation
    w_p1 = torch.from_numpy(p1.default_w()).to(dev)
    w_body = pb.prepare(pb.weights(), dev)
    w_b2 = p4.prepare(p4.weights(), dev)

    def runs(kind, key):
        """(kernel fn, plain fn, tol) of a probe variant: fn(w, T, dil) ->
        (out, skip), skip None for P1."""
        if kind == "taps":
            return (lambda w, T, dil: (p1.taps(key, w, B=B, T=T, dil=dil), None),
                    lambda w, T, dil: (p1.taps_plain(key, w, B=B, T=T, dil=dil), None),
                    PROBE_F32_TOL)
        if kind in ("resident", "streamed"):
            kern, plain = getattr(pb, kind), getattr(pb, f"{kind}_plain")
            return (lambda w, T, dil, **kw: kern(w, B=B, T=T, dil=dil, **kw),
                    lambda w, T, dil: plain(w, B=B, T=T, dil=dil), PROBE_BF16_TOL)
        return (lambda w, T, dil: p4.body2(w, key, B=B, T=T, dil=dil),
                lambda w, T, dil: p4.body2_plain(w, key, B=B, T=T, dil=dil), PROBE_BF16_TOL)

    def errs(got, want):
        pairs = [(got[0], want[0])] + ([(got[1], want[1])] if want[1] is not None else [])
        rel = max(rel_err(g, w_) for g, w_ in pairs)
        absd = max((g - w_).abs().max().item() for g, w_ in pairs)
        return rel, absd

    report, wants = {}, {}
    # (ii) at the probes' constants
    for (kind, key) in timed:
        kern, plain, tol = runs(kind, key)
        w = {"taps": w_p1, "body2": w_b2}.get(kind, w_body)
        T = p1.T if kind == "taps" else pb.T
        got = kern(w, T, dil)
        want, p_ms = events_ms(lambda: plain(w, T, dil))
        wants[kind] = want
        rel, absd = errs(got, want)
        alive = want[0].abs().max().item() > DECAYED
        b_ms, b_by = probe_bound(kind, w, B, T, key if kind == "body2" else 0)
        t = timed[(kind, key)]
        name = f"{kind}[{key}]" if key is not None else kind
        print(f"probe {name} [{card}] B={B} T={T}: kernel {t['ms']:.2f} ms "
              f"({t['us_per_step']:.2f} us/sample, {t['us_per_step'] / p1.LAYERS * 1e3:.0f} "
              f"ns/layer), plain {p_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}); "
              f"rel err {rel:.3e} (limit {tol}), max abs err {absd:.3e}, max |ref| "
              f"{want[0].abs().max().item():.3e}{'' if alive else ' (decayed: held below)'}",
              flush=True)
        check(math.isfinite(absd), f"probe {name}: non-finite output")
        if alive:
            check(rel <= tol, f"probe {name} kernel vs plain {rel}")
        report[(kind, key)] = {"ms": t["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "max_abs_err": absd,
                               "rel_err": rel if alive else 0.0}  # decayed: not held here

    probe_profile(pb, w_body, dil, B, card)

    # (iii) the checks that can fail, at SHORT_T, with corrupted variants
    gen = np.random.RandomState(1)
    short_w = {g: torch.from_numpy((gen.randn(p1.R, p1.R) * g / math.sqrt(p1.R)).astype(
        np.float32)).to(dev) for g in (0.6, 0.3)}
    w_b2_short = dict(w_b2, cond_in=w_b2["cond_in"][:SHORT_T])
    for (kind, key) in timed:
        kern, plain, tol = runs(kind, key)
        T = SHORT_T
        if kind == "taps":
            # the probe's w underflows; gain 0.6 / sqrt(R) keeps h alive over
            # 65 x 24 layers without chaos, compute (3h) at 0.3 over 8 steps
            w = short_w[0.3 if key == "compute" else 0.6]
            T = 8 if key == "compute" else SHORT_T
        else:
            w = w_b2_short if kind == "body2" else w_body
        want = plain(w, T, dil)
        rel, absd = errs(kern(w, T, dil), want)
        bad = {}
        if kind == "taps" and key != "dynamic":
            wz = w.clone()
            wz[:, 5] = 0
            bad["w column 5 zeroed"] = kern(wz, T, dil)
        else:
            bad["layer 23 at half its dilation"] = kern(w, T, bad_dil)
        if kind == "resident":
            bad["P3's cond rule"] = kern(w, T, dil, cond_rule="layer")
        if kind == "streamed":
            bad["P2's cond rule"] = kern(w, T, dil, cond_rule="step")
        name = f"{kind}[{key}]" if key is not None else kind
        bad_rel = {what: errs(out, want)[0] for what, out in bad.items()}
        print(f"probe check {name} [{card}] T={T}: rel err {rel:.3e} (limit {tol}), max abs "
              f"err {absd:.3e}, ref rms {want[0].pow(2).mean().sqrt().item():.3e}; corrupted: "
              + ", ".join(f"{k} {v:.3e}" for k, v in bad_rel.items()), flush=True)
        check(rel <= tol, f"probe {name} kernel vs plain at T={T}: {rel}")
        for what, v in bad_rel.items():
            check(v > tol, f"the probe check of {name} passes a kernel with {what}")
        r = report[(kind, key)]
        r["max_abs_err"] = max(r["max_abs_err"], absd)
        r["rel_err"] = max(r["rel_err"], rel)
        r["launches"] = launches[(kind, key)]
        r["us_per_step"] = timed[(kind, key)]["us_per_step"]

    # P2 and P3 at the probes' constants, with each other's cond rule
    for kind, wrong in (("resident", "layer"), ("streamed", "step")):
        kern, _, tol = runs(kind, None)
        v = errs(kern(w_body, pb.T, dil, cond_rule=wrong), wants[kind])[0]
        print(f"probe check {kind} [{card}] T={pb.T}: the other's cond rule {v:.3e} "
              f"(limit {tol})", flush=True)
        check(v > tol, f"the {kind} check passes the other probe's cond rule at T={pb.T}")
    return report


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

    # the float32 fine check across the row tile: 9 batch rows, tiles of 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = ws.pack_wavenet_params(det, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(19)
    frames = torch.rand(9, 256 // det.hop, vcfg.cin_channels, device=dev, generator=g)
    with torch.inference_mode():
        cond9 = det.upsample(frames).contiguous()
    tile9 = ws.block_plan(f32, 9, sms)["tile"]
    plain = ws.wavenet_generate_plain(f32, cond9, 0, True)
    err = (ws.wavenet_generate(f32, cond9, 0, True) - plain).abs().max().item()
    print(f"kernel vs plain [{card}] float32 B=9 T={cond9.shape[1]} (row tile {tile9}): "
          f"max_abs_err {err:.3e} (atol {F32_ATOL}); trajectory std {plain.std().item():.4f}",
          flush=True)
    check(tile9 < 9, "the B=9 check does not cross the row tile")
    check(math.isfinite(err) and err <= F32_ATOL, f"float32 B=9 kernel vs plain {err}")
    check(plain.std().item() > TRAJ_STD, "doctored B=9 trajectory does not move")

    rnd = seeded(lambda: WaveNet(vcfg), SEED + 2).to(dev).eval()
    packed = ws.pack_wavenet_params(rnd, torch.bfloat16, dev)
    s1 = ws.wavenet_generate(packed, cond, 1)
    s1b = ws.wavenet_generate(packed, cond, 1)
    s2 = ws.wavenet_generate(packed, cond, 2)
    s1c, draws, _ = ws.wavenet_generate_checked(packed, cond, 1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(s1).all()) and s1.abs().max().item() <= 1.0,
          "stochastic output not finite in [-1, 1]")
    check(torch.equal(s1, s1b), "same seed, different samples")
    check(not torch.equal(s1, s2), "different seeds, same samples")
    check(torch.equal(s1c, s1) and bool((draws == s1[None]).all()),
          "the blocks' stochastic draws disagree")
    print(f"stochastic mode: finite in [-1, 1], repeatable per seed, seeds differ; all "
          f"{draws.shape[0]} blocks drew the same {draws[0].numel()} samples", flush=True)

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
        ws.wavenet_generate.launches.clear()
        ws.mol_sample.launches = 0
        t_main = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(post, (1, 2, 3)))
        main_s = time.perf_counter() - t_main
        launches = ws.wavenet_generate.launches["bfloat16"]
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
    check(launches > 0, "the main path did not launch the bf16 CUDA kernel")
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
        checked, draws, _ = ws.wavenet_generate_checked(packed, cond, 0, True)
        check(bool((draws == checked[None]).all()), f"{dtype}: the blocks' draws disagree")
        kern, k_ms = events_ms(lambda: ws.wavenet_generate(packed, cond, 0, True))
        check(torch.equal(kern, checked), f"{dtype}: the timed call differs from the checked one")
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
    k1 = {"launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bound_by": b_by}  # bf16: the main path's weights

    # 5. the block plans; us per step by batch; where a step's time goes -----
    q8 = ws.pack_wavenet_params(det, torch.bfloat16, dev, quantize=True)
    f32 = ws.pack_wavenet_params(det, torch.float32, dev)
    for name, pk in (("float32", f32), ("bfloat16", packed), ("int8", q8)):
        pl = ws.block_plan(pk, b_main, sms)
        print(f"block plan {name} B={b_main} on {sms} SMs: {pl['blocks']} blocks of "
              f"{pl['pairs']} gate pairs, {pl['rows']} skip/out rows, {pl['cols']} final1 "
              f"columns; row tile {pl['tile']}; {pl['resident_layers']} of {vcfg.layers} "
              f"layers resident, {pl['resident_bytes']} B of weights, scales and biases "
              f"resident a block ({pl['smem_bytes']} B of shared memory); "
              f"{pl['streamed_bytes_per_step'] / 1e6:.1f} MB a step streamed", flush=True)
    n_bar = 2 * vcfg.layers + 1
    print(f"barrier floor: {n_bar} grid barriers a step x {BARRIER_US} us = "
          f"{n_bar * BARRIER_US:.1f} us a sample step", flush=True)
    sweep = {}
    for name, pk in (("bfloat16", packed), ("int8", q8)):
        for b in (1, 3, 4, 8):
            g = torch.Generator(device=dev).manual_seed(50 + b)
            frames = torch.rand(b, 1024 // det.hop, vcfg.cin_channels, device=dev, generator=g)
            with torch.inference_mode():
                cond_b = det.upsample(frames).contiguous()
            ws.wavenet_generate(pk, cond_b, 0, True)
            _, ms = events_ms(lambda: ws.wavenet_generate(pk, cond_b, 0, True))
            sweep[(name, b)] = ms * 1e3 / cond_b.shape[1]
            prev = PREV_US.get((name, b))
            print(f"per step [{card}] {name} B={b} T={cond_b.shape[1]}: {sweep[(name, b)]:.1f} "
                  f"us/sample-step; per-launch design " +
                  (f"{prev} (PERF.md)" if prev else "not measured"), flush=True)
        _, _, stamps = ws.wavenet_generate_checked(pk, cond[:, :512].contiguous(), 0, True,
                                                   stamp_steps=512)
        split = phase_split(stamps, vcfg.layers)
        print(f"phase split [{card}] {name} B={b_main}: share of block 0's cycles "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)

    # 6. int8 weight streaming -------------------------------------------------
    # (i) the fine check.  int8 activations are bf16 whatever the weights, so
    # the sum order flips bf16 roundings as in the bf16 check.  Here few flip
    # and none is amplified: a narrow width, final1 in float32 (its bf16
    # rounding of the skip sum flips most), and first_conv zeroed, so no flip
    # is fed back through the sampled output (with feedback this width is
    # chaotic, PERF.md).  The layer kernels are the ones generate's
    # bf16-final1 default runs.
    ncfg = VocoderConfig(**NARROW)
    narrow = doctor_head(seeded(lambda: WaveNet(ncfg), SEED + 5).to(dev).eval())
    with torch.no_grad():
        narrow.first_conv.weight.zero_()
    g = torch.Generator(device=dev).manual_seed(30)
    frames = torch.rand(4, 1024 // narrow.hop, ncfg.cin_channels, device=dev, generator=g)
    with torch.inference_mode():
        cond_n = narrow.upsample(frames).contiguous()
    npk = ws.pack_wavenet_params(narrow, torch.float32, dev, quantize=True)
    kern = ws.wavenet_generate(npk, cond_n, 0, True)
    plain = ws.wavenet_generate_plain(npk, cond_n, 0, True)
    err = (kern - plain).abs().max().item()
    bad_err = (ws.wavenet_generate(swapped_scales(npk, [3]), cond_n, 0, True)
               - plain).abs().max().item()
    print(f"int8 fine check [{card}] narrow L={ncfg.layers} R={ncfg.residual_channels}, "
          f"final1 float32, no feedback, B=4 T={cond_n.shape[1]}: max_abs_err {err:.3e} "
          f"(atol {INT8_FINE_ATOL}); trajectory std {plain.std().item():.4f}; layer-3 tap "
          f"scales swapped: {bad_err:.3e}", flush=True)
    check(math.isfinite(err) and err <= INT8_FINE_ATOL, f"narrow int8 kernel vs plain {err}")
    check(plain.std().item() > TRAJ_STD, "narrow doctored trajectory does not move")
    check(bad_err > INT8_FINE_ATOL, "the int8 fine check passes swapped tap scales")

    # (ii) the coarse check at full width; bf16 final1, generate's default
    for b in (1, 4):
        g = torch.Generator(device=dev).manual_seed(10 + b)  # phase 2's frames
        frames = torch.rand(b, 1024 // det.hop, vcfg.cin_channels, device=dev, generator=g)
        with torch.inference_mode():
            cond_b = det.upsample(frames).contiguous()
        t = cond_b.shape[1]
        ws.wavenet_generate(q8, cond_b, 0, True)
        kern, k_ms = events_ms(lambda: ws.wavenet_generate(q8, cond_b, 0, True))
        plain, p_ms = events_ms(lambda: ws.wavenet_generate_plain(q8, cond_b, 0, True))
        err = (kern - plain).abs().max().item()
        bad_err = (ws.wavenet_generate(swapped_scales(q8, slice(None)), cond_b, 0, True)
                   - plain).abs().max().item()
        print(f"kernel vs plain [{card}] int8 B={b} T={t}: max_abs_err {err:.3e} (atol "
              f"{BF16_ATOL}); trajectory std {plain.std().item():.4f}; kernel "
              f"{k_ms * 1e3 / t:.1f} us/sample-step, plain {p_ms * 1e3 / t:.1f} "
              f"us/sample-step, HBM-streaming bound {stream_us(q8):.1f} us; tap scales "
              f"swapped in every layer: {bad_err:.3e}", flush=True)
        check(math.isfinite(err) and err <= BF16_ATOL, f"int8 B={b} kernel vs plain {err}")
        check(plain.std().item() > TRAJ_STD, "doctored int8 trajectory does not move")
        # reported, not required: at full width the swap hides in the bf16
        # noise (PERF.md), as the bf16 check's corrupted packs do

    # (iii) stochastic mode
    q8r = ws.pack_wavenet_params(rnd, torch.bfloat16, dev, quantize=True)
    s1 = ws.wavenet_generate(q8r, cond_b, 1)
    s1b = ws.wavenet_generate(q8r, cond_b, 1)
    s2 = ws.wavenet_generate(q8r, cond_b, 2)
    s1c, draws, _ = ws.wavenet_generate_checked(q8r, cond_b, 1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(s1).all()) and s1.abs().max().item() <= 1.0,
          "int8 stochastic output not finite in [-1, 1]")
    check(torch.equal(s1, s1b), "int8: same seed, different samples")
    check(not torch.equal(s1, s2), "int8: different seeds, same samples")
    check(torch.equal(s1c, s1) and bool((draws == s1[None]).all()),
          "int8: the blocks' stochastic draws disagree")
    print(f"int8 stochastic mode: finite in [-1, 1], repeatable per seed, seeds differ; all "
          f"{draws.shape[0]} blocks drew the same {draws[0].numel()} samples", flush=True)

    # (iv) its main path: generate on mel frames, at full width
    voc8 = seeded(lambda: WaveNet(vcfg), SEED + 4).to(dev).eval()  # phase 3's weights
    g = torch.Generator(device=dev).manual_seed(40)
    mels = torch.rand(b_main, f_main, vcfg.cin_channels, device=dev, generator=g)

    def gen8(c):
        return ws.generate(voc8, c, 7, quantize_int8=True)

    gen8(mels[:, :2])  # warm-up: the int8 pack and its upload
    torch.cuda.synchronize()
    ws.wavenet_generate.launches.clear()
    t_main = time.perf_counter()
    wav8 = gen8(mels)
    torch.cuda.synchronize()
    main8_s = time.perf_counter() - t_main
    launches8 = ws.wavenet_generate.launches["int8"]
    check(wav8.shape == (b_main, f_main * hop), f"int8 main path output {tuple(wav8.shape)}")
    check(bool(torch.isfinite(wav8).all()) and wav8.abs().max().item() <= 1.0,
          "int8 main path output not finite in [-1, 1]")
    check(launches8 > 0, "the int8 main path did not launch the int8 CUDA kernel")
    print(f"int8 main path [{card}]: generate(quantize_int8=True) on {tuple(mels.shape)} mel "
          f"frames -> {tuple(wav8.shape)} in {main8_s:.2f} s; int8 launches {launches8}",
          flush=True)

    # (v) the kernel against its plain version at that path's shape, at full
    # width, with the output feedback cut (first_conv zeroed), so that no
    # bf16 rounding flip is fed back and the limits can be tight.  First the
    # int8 pack with final1 in float32 (the layer kernels alone) against
    # wavenet_generate_plain; then the packs the two main paths run, bf16 and
    # int8 with bf16 final1 (generate's default), against
    # wavenet_open_loop_plain: the same function over all steps at once,
    # held here to wavenet_generate_plain on the first pack.
    _, q8_ms = events_ms(lambda: ws.wavenet_generate(q8, cond, 0, True))
    nofb = copy.deepcopy(det)
    with torch.no_grad():
        nofb.first_conv.weight.zero_()
    f8 = ws.pack_wavenet_params(nofb, torch.float32, dev, quantize=True)
    kern8, _ = events_ms(lambda: ws.wavenet_generate(f8, cond, 0, True))
    _, k8_ms = events_ms(lambda: ws.wavenet_generate(f8, cond, 0, True))
    plain8, p8_ms = events_ms(lambda: ws.wavenet_generate_plain(f8, cond, 0, True))
    open8, o8_ms = events_ms(lambda: ws.wavenet_open_loop_plain(f8, cond))
    ol_max = (open8 - plain8).abs().max().item()
    ol_rms = (open8 - plain8).pow(2).mean().sqrt().item()
    b8_ms, b8_by = bound(f8, cond)
    print(f"kernel at main-path shapes [{card}] cond {tuple(cond.shape)} int8, final1 float32, "
          f"no feedback: {k8_ms:.1f} ms ({k8_ms * 1e3 / cond.shape[1]:.1f} us/sample-step; "
          f"generate's bf16-final1 pack {q8_ms:.1f} ms), plain {p8_ms:.1f} ms, bound "
          f"{b8_ms:.3f} ms ({b8_by}); the open-loop plain version ({o8_ms:.1f} ms) against "
          f"the plain version: max_abs_err {ol_max:.3e}, rms err {ol_rms:.3e} (the kernel's "
          f"limits, atol {INT8_FULL_ATOL}, rms {INT8_FULL_RMS})", flush=True)
    check(math.isfinite(ol_max) and ol_max <= INT8_FULL_ATOL and ol_rms <= INT8_FULL_RMS,
          f"the open-loop plain version disagrees with the plain version: {ol_max} "
          f"(rms {ol_rms})")

    def held(name, kern, ref, atol, rms, bad):
        """kern against ref within atol (max) and rms, and every corrupted
        pack of bad {what: (pack, whether it must fail)} rejected; returns
        the max error."""
        def errs(out):
            d = out - ref
            return d.abs().max().item(), d.pow(2).mean().sqrt().item()

        def passes(e):
            return math.isfinite(e[0]) and e[0] <= atol and e[1] <= rms

        err, std = errs(kern), ref.std().item()
        limits = f"(atol {atol}, rms {rms})"
        print(f"kernel vs plain at main-path shapes [{card}] {name}, no feedback: max_abs_err "
              f"{err[0]:.3e}, rms err {err[1]:.3e} {limits}; trajectory std {std:.4f}",
              flush=True)
        check(passes(err), f"main-shape {name} kernel vs plain {err[0]} (rms {err[1]})")
        check(std > MAIN_STD, f"doctored {name} trajectory does not move")
        rejected = []
        for what, (pack, must) in bad.items():
            e = errs(ws.wavenet_generate(pack, cond, 0, True))
            print(f"corrupted {name} pack [main-path shape] {what}: max_abs_err {e[0]:.3e}, "
                  f"rms err {e[1]:.3e} {limits}{'' if must else ', reported'}", flush=True)
            rejected.append((what, not must or not passes(e)))
        for what, ok in rejected:
            check(ok, f"the main-shape {name} check passes a pack with {what}")
        return err[0]

    err8 = held("int8, final1 float32", kern8, plain8, INT8_FULL_ATOL, INT8_FULL_RMS,
                int8_corrupted(f8))
    for name, pk in (("bfloat16", ws.pack_wavenet_params(nofb, torch.bfloat16, dev)),
                     ("int8", ws.pack_wavenet_params(nofb, torch.bfloat16, dev, quantize=True))):
        kern, draws, _ = ws.wavenet_generate_checked(pk, cond, 0, True)
        check(bool((draws == kern[None]).all()), f"{name}, no feedback: the blocks' draws disagree")
        held(name, kern, ws.wavenet_open_loop_plain(pk, cond), MAIN_NOFB_ATOL, MAIN_NOFB_RMS,
             nofb_corrupted(pk))

    # (vi) one launch a call: the profiler's records of both main paths' calls
    steps = f_main * hop
    ws.generate(voc8, mels[:, :2], 7)  # warm-up: the bf16 pack
    profile(lambda: ws.generate(voc8, mels, 7), card, f"bf16 main path, generate on "
            f"{tuple(mels.shape)} mel frames", steps)
    profile(lambda: gen8(mels), card, f"int8 main path, generate(quantize_int8=True) on "
            f"{tuple(mels.shape)} mel frames", steps)

    k3 = {"launches": launches8, "max_abs_err": err8, "ms": k8_ms, "plain_ms": p8_ms,
          "bound_ms": b8_ms, "bound_by": b8_by}

    # 7. the tools/ probes ------------------------------------------------------
    pr = probes(card, dev)

    def probe_entry(name, src, replaces, kind, main_key):
        """One report entry per probe kernel: the times of main_key's
        variant (P1 dynamic, P4 stage 4), launches and errors over all."""
        keys = [k for k in pr if k[0] == kind]
        entry = {"name": name, "route": "cuda", "source": f"dvc_tpu_torch/kernels/csrc/{src}",
                 "replaces": replaces, "launches": sum(pr[k]["launches"] for k in keys),
                 "max_abs_err": max(pr[k]["max_abs_err"] for k in keys),
                 **{f: pr[(kind, main_key)][f] for f in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by")},
                 "library_ms": None}  # no single PyTorch call runs these recurrences
        if len(keys) > 1:
            entry["variants"] = {str(k[1]): {f: pr[k][f] for f in ("launches", "ms", "plain_ms",
                                                                    "bound_ms", "rel_err")}
                                 for k in keys}
        return entry

    p2_us = pr[("resident", None)]["us_per_step"]
    print(f"B=8 against P2 [{card}]: bfloat16 {sweep[('bfloat16', 8)]:.1f}, int8 "
          f"{sweep[('int8', 8)]:.1f} us/sample-step; P2 in this run {p2_us:.1f}", flush=True)

    src = "dvc_tpu_torch/kernels/csrc/wavenet_step.cu"
    report = {"kernels": [  # library_ms: no single PyTorch call computes AR generation
        {"name": "wavenet_generate", "route": "cuda", "source": src,
         "replaces": "dvc_tpu/kernels/wavenet_step.py:415", **k1, "library_ms": None},
        {"name": "wavenet_generate_int8", "route": "cuda", "source": src,
         "replaces": "dvc_tpu/kernels/wavenet_step.py:771", **k3, "library_ms": None},
        probe_entry("probe_taps", "bench_taps.cu", "tools/bench_taps.py:66", "taps", "dynamic"),
        probe_entry("probe_resident", "probe_body.cu", "tools/bench_body.py:95", "resident",
                    None),
        probe_entry("probe_streamed", "probe_body.cu", "tools/bench_body.py:165", "streamed",
                    None),
        probe_entry("probe_body2", "probe_body.cu", "tools/bench_body2.py:123", "body2", 4),
    ]}
    print(json.dumps(report), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
