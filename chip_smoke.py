#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (dvc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before a result line is printed:
  1. build  every kernel under dvc_tpu_torch/kernels/csrc, one nvcc each,
            and the native engines under dvc_tpu_torch/native, one g++
            each, all started together;
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
            gave it, at the limits above: the closed-loop plain sampler on
            the first F32_MAIN_STEPS steps (its depth cut to keep the
            script's time), float32 over those steps and bf16 over all its
            steps, whose first F32_MAIN_STEPS equal a run on those alone;
            every step of both against the plain function teacher-forced on
            the kernel's own samples (every block's draws equal; the timed
            call's output is the one compared, and equals the check run's);
            timed with CUDA events, kernel and plain on the same steps for
            the kernels line (which gives each entry's steps), the bf16
            kernel over all its steps too;
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
            final1 in float32 against the plain version over the path's
            first F32_MAIN_STEPS steps (the plain sampler's depth cut as in
            phase 4; the kernel's line is timed there), with packs whose
            scales are wrong rejected; the open-loop plain version over all
            steps held to the plain version on those; the bf16 pack and generate's int8
            pack (bf16 final1), the packs the main paths run, against the
            open-loop plain version (all steps at once), every block's
            draws equal,
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
            reads every tap (P1 with a weight of larger gain), at B in {1, 3,
            8, 9}, where a kernel with layer 23 at half its dilation (P1
            static and compute: a zeroed w column), and P2 and P3 with each
            other's cond rule (also at T = 1000), must be rejected; the plans
            of P1's cluster kernel, of body_mma (P2, P4) and of P3's two
            kernels (a block of each on one SM) on the card against their
            wrappers' own; P3 under the profiler (its kernels from the CUDA
            graph, the idle share); tools/ablate_body once (P2's and P3's
            split by variant); tools/bench_sync once (clusters at once, us a
            cluster and a grid barrier, us a launch by stream, graph and
            PDL);
  8. train  the VAE training path at the full VAEConfig (no hand kernel:
            cuDNN/cuBLAS, float32, TF32 off): Trainer.run_training at
            training.sh's batch 8 on a synthetic corpus made as in phase 3
            (16 utterances a speaker), finite losses and a checkpoint, then
            the loss falling over 10 steps on one batch; one float32 step on
            the card against the same step on the CPU (same weights, batch
            and injected noise: loss terms, gradients, BN running stats at
            the limits of tests/test_torch_port_train.py); ms a step, mel
            frames/s and peak memory at bench.py's batch 256, and the
            profiler's busy share and kernels over 3 steps;
  9. serve  the serving defaults: `python -m dvc_tpu_torch.cli.run serve`
            as a child process with the Griffin-Lim default on phase 8's
            checkpoint answers 3 concurrent POST /convert (one at 22.05 kHz,
            resampled), and `serve --profile_transfer` answers 2 (one at
            44.1 kHz); Griffin-Lim (after one iteration, and by spectral
            convergence after 32) and resample_poly on the card against the
            CPU.
 10. recipe the verify recipe through the CLI on the card at full width
            (AudioConfig, VAEConfig, WORLD at 5 ms and 36 coefficients), in
            a temporary directory: a VCTK-layout corpus (4 speakers x 12
            utterances of 2-4 s, harmonic with a moving f0, a noise floor
            and a 0.5-1 s silent gap; one speaker at 48 kHz) -> `preprocess`
            as a child process with the gmm VAD trim and with --no_trim
            (file counts, (80, T) mels in [0, 1], every mel against the
            port's CPU run, the VAD masks on the card equal to the CPU's) ->
            (the two at once, beside the CPU runs here) ->
            `train` 2 epochs at batch 8 on the --no_trim mels (.msgpack,
            .pth and .opt.pth; the .msgpack alone resumes to the .pth
            pair's weights, Adam state and step) -> `convert` for two
            speaker pairs with Griffin-Lim at once, and in this process one
            utterance with --vocoder_ckpt at a WaveNet .msgpack written from
            seeded weights by the port's writer (exactly one
            wavenet_persistent launch, by the profiler and by the counter)
            -> `eval-mcd` (finite MCDs, sources against themselves 0.0,
            each MCD within 1e-3 dB of the port's CPU analysis); seconds of
            each step, the preprocess and analysis rates.
 11. vocoder the vocoders trained and served, at full width: (i)
            `train-vocoder` (the WaveNet at the CLI defaults, and --arch
            istft) as two child processes at once, 300 steps each on phase
            10's corpus (p228 at 48 kHz, so the resampler runs): a
            checkpoint each, finite logged losses, and each checkpoint's
            mean loss over 4 held batches below its initial weights'; (ii)
            meanwhile one
            step of each on the card against the same step on the CPU (the
            WaveNet at dropout 0 on 2 x 1024 samples, the iSTFT vocoder on
            train-vocoder's 2 x 31 frames): loss terms 1e-5 relative, each
            gradient 1e-3 of its max (the iSTFT gradient, ill-conditioned in
            float32: 1e-2 in float32, and the same step in float64 on both,
            1e-6), the card's first Adam / clip + AdamW
            update against its formula within 1e-3 of the learning rate and
            the EMA within 1e-6; (iii) `serve --vocoder istft` on phase 8's
            checkpoint answers 3 concurrent 0.5 s requests in one drain; the
            iSTFT synthesis of those requests' mels (the same VAE served
            here without a vocoder) on the card against the CPU within 1e-4
            of the peak, timed, and its real-time factor; (iv) `convert`
            with the trained WaveNet's msgpack (exactly one
            wavenet_persistent launch, by the profiler and by the counter),
            then the kernel on its EMA weights: bf16 at the main path's
            shape with the feedback cut against the open-loop plain version
            at max 4e-3 / rms 3e-4 (inside phase 6 (v)'s limits, which it
            also reports), after float32 with the feedback on at
            B = 3, T = 1024 against the plain version (atol 5e-5), each with
            a layer-0 ring tap at twice its dilation reported caught or not;
            (v) ms a train step and peak memory of each arch at
            train-vocoder's shapes.
 12. latent the mel VAE's remaining train and convert options (no hand
            kernel: cuDNN/cuBLAS), on phase 10's corpus and run: (i) at the
            full VAEConfig, batch 8, float32: one adversarial step in each
            mode (confusion, grl) on the card against the CPU (same VAE,
            adversary, batch and injected noise; loss terms and adv_ce 1e-5
            relative, adv_acc equal, both nets' gradients 1e-3 of their max,
            phase 8's limits); the remat step against the plain step on the
            card (gradients 1e-5 of their max, BN running statistics equal
            and counted once); one FeatureSelection step card against CPU
            (loss 1e-5 relative, updated weights 1e-5 where the gradient is
            above 1e-6, every step within 2 lr); convert_mel_long_context
            with phase 10's checkpoint card against CPU (mels 1e-4, phase
            10's limit); (iii) `train --adv_cof 1` (2 epochs, batch 8:
            finite losses, the Adversary CE / Acc scalars, a checkpoint, the
            estimation PNGs) and `train-fs` (feature_mask.npz) as children at
            once, then `convert --fs_mask ... --analyze` and `convert
            --long_context --analyze` at once (Griffin-Lim wavs,
            latent_analysis.npz, fs_mask.npz; the PNGs where matplotlib
            imports); (ii) then ms a step and peak memory at bench.py's
            batch of the plain, adversarial and remat steps, beside phase
            8's plain step.
 13. speaker the GE2E speaker encoder and the AutoVC baseline (no hand
            kernel: cuDNN/cuBLAS, float32, TF32 off): (i) one GE2E step at
            the full SpeakerEncoderConfig on a seeded (64, 10, 63, 80)
            batch and one AutoVC step at the full AutoVCConfig, batch 8 x
            64, on the card against the CPU in float32 and float64 (loss
            terms 1e-5 relative, the similarity matrix 1e-5 of its max, each
            gradient 1e-3 of its max in float64 and 0.1 in float32, the
            similarity gradients 1e-8 absolute, pre-BN conv biases by their
            share, running statistics 1e-5), the card's first GE2E update
            against Adam's formula, an AutoVC step without the gradient
            through the running statistics rejected, embed_utterance of a
            phase 10 wav (1e-4); (iii) on a synthetic corpus of 64 speakers
            (12 training and 4 held-out mels each) `train-speaker` 300 steps
            at 64 x 10 on the resident pool and `train-autovc` with one-hot
            codes on phase 10's mels as children at once, then `eval-eer`
            of the trained and the initial weights on the held-out mels (the
            trained EER lower), `embed` over phase 10's wavs and
            `train-autovc --encoder_run_id` (2 epochs at batch 8 each, the
            loss falling, checkpoints the port reads); (ii) then ms a step,
            TFLOP/s against the float32 bound, peak memory and the idle
            share of both steps;
 14. world  the WORLD route on phase 10's corpus (no hand kernel: dvc_tpu
            reaches no pl.pallas_call there): (iii) `preprocess-world`
            --f0 native and --f0 device as children at once (the same
            files and keys; normalized_mc device against native, the
            median over frames of the largest difference 0.05); (i)
            meanwhile world_decompose_batch on the 48 wavs on the card,
            harvest_batch's seconds and its frame scans' share timed, the
            card's f0 against the native engine per wav (voicing agreement
            0.93, median relative error 0.01); (ii) synthesize_batch on
            the card against the CPU with the same noise (1e-4 of the
            peak); (iii) `train --features mcc` 2 epochs at batch 8 on the
            --f0 device features, then
            `convert-world` (native synthesis) and `convert-world --synth
            device` and `serve --pipeline world` answering 3 concurrent
            requests (one at 22.05 kHz) at once, then `eval-mcd
            --analysis device` and `--analysis native` on the converted
            wavs (the mean MCD within 5%); (i) the CPU's world_decompose_batch on
            the 48 wavs, in a thread beside the children: Harvest card
            against CPU (voicing agreement 0.99, median relative error
            1e-4), the mc card against CPU (1e-3 of its range).
 15. parallel the mesh layer (dvc_tpu_torch/parallel, torch.distributed; no
            hand kernel: NCCL's collectives are GSPMD's): a one-rank NCCL
            group through a FileStore, then (i) Trainer's mesh branch (the
            default use_mesh) at the full VAEConfig and bench.py's 256 x 64
            against the plain step from the same weights, batch and seed
            (loss terms 1e-5 relative, phase 8's gradient and statistics
            limits), both timed in turns, the ratio and the peak memory,
            and ShardedLSTM (the tensor-parallel LSTM) over the one-rank
            group against the nn.LSTM it wraps, forward and backward;
            (ii) the GE2E step with a mesh against the plain step; (iii)
            whole_utterance_encode(mesh) on the card against the CPU; (iv)
            with two cards or more, two NCCL ranks (chip_smoke.py
            --parallel-rank) running the full-width VAE step sharded dp 2
            (ZeRO) and mp 2 (tensor parallel) in float64 (phase 8's
            gradient limit), and the halo conv, against one process, each
            state then saved as an orbax checkpoint (each rank its own
            store) and gathered into a msgpack, the two read back equal in
            one process, then `train` through torchrun on two cards against
            one process (epoch losses, rank 0's checkpoints); with one card
            it says so.
 16. orbax  dvc_tpu's orbax checkpoints and the device D4C (no hand kernel:
            dvc_tpu reaches no pl.pallas_call there): (i) Trainer at the
            full VAEConfig, batch 8, one epoch on phase 8's corpus, its
            orbax save (Trainer.save) read back bit-equal to its state, the
            save, the orbax write and the read timed, the bytes on disk;
            (ii) an orbax resume and a msgpack resume of that state, each
            one more epoch (cuDNN deterministic), losses equal within 1e-6;
            (iii) d4c_batch on phase 10's 48 wavs at 16 kHz on the card,
            timed, against the CPU on every fourth wav (voiced frames 2e-4,
            the rest 1 within 1e-6), and world_decompose_batch(keep_sp_ap=
            True) on 8 wavs.
Each phase prints its seconds.  The lines before the last report the card
(nvidia-smi name and power limit), timings and one JSON line of kernels
(phases 8-16 add none); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import io
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
F32_MAIN_STEPS = 4096  # phase 4's plain samplers and phase 6 (v)'s: the first steps of the
                       # main path's cond (the sampler is causal, so they are the full
                       # run's first steps)
MAIN_STD = 0.02    # required over the main path's first 4,096 steps, where the
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
PROBE_CHECK_BS = (1, 3, 8, 9)  # batch sizes of those checks: P1's clusters, P2/P4's n-tiles
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


def busy_union(spans) -> float:
    """The length of the union of (start, end) spans."""
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def probe_profile(pb, w, dil, B, card, steps=100):
    """Where P3's time goes: one streamed call of `steps` steps under
    torch.profiler, its kernels from the CUDA graph (streamed_in and
    streamed_out, 2L a step: the phases that P2 runs between grid
    barriers) and the device's busy time as the union of every kernel's
    span.  Under programmatic dependent launch a kernel's span starts when
    its blocks do, in its predecessor's tail, so spans overlap and their
    sum overstates the busy time.  The idle share is read over the call's
    events (the graph's capture included) and over the kernels' window."""
    layers = len(dil)
    want = {"streamed_in": layers * steps, "streamed_out": layers * steps}
    pb.streamed(w, B=B, T=steps, dil=dil)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, ms = events_ms(lambda: pb.streamed(w, B=B, T=steps, dil=dil))
    spans, by_kernel = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        if b <= a:
            continue
        spans.append((a, b))
        for part in want:
            if part in e.name:
                n_, us_ = by_kernel.get(part, (0, 0.0))
                by_kernel[part] = (n_ + 1, us_ + (b - a))
    if set(by_kernel) != set(want):
        print(f"profile P3 [{card}]: the profiler recorded no device time of "
              f"{sorted(set(want) - set(by_kernel))} (not measured)", flush=True)
        return
    busy = busy_union(spans)
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    summed = sum(us for _, us in by_kernel.values())
    parts = ", ".join(f"{k} span {us / n:.2f} us x {n}/{want[k]}"
                      for k, (n, us) in by_kernel.items())
    print(f"profile P3 [{card}] B={B} T={steps}: {ms * 1e3 / steps:.1f} us/sample by events "
          f"(the graph's capture and instantiation {pb.streamed.graph_us:.0f} us of it), device "
          f"busy {busy / steps:.1f} us/step by the union of kernel spans: idle share "
          f"{1 - busy / (ms * 1e3):.3f} of the call, {1 - busy / window:.3f} of the kernels' "
          f"window; kernel spans summed {summed / busy:.2f}x the union; {parts}", flush=True)


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
    p3_graph_us = pb.streamed.graph_us  # the timed call's graph, captured in each call
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
    probe_plans(card, dev, p1, pb, dil)
    bad_dil = dil.copy()
    bad_dil[23] //= 2  # the last layer reads its taps at half its dilation
    w_p1 = torch.from_numpy(p1.default_w()).to(dev)
    w_body = pb.prepare(pb.weights(), dev)
    w_b2 = p4.prepare(p4.weights(), dev)

    def runs(kind, key):
        """(kernel fn, plain fn, tol) of a probe variant: fn(w, T, dil, B) ->
        (out, skip), skip None for P1."""
        if kind == "taps":
            return (lambda w, T, dil, B: (p1.taps(key, w, B=B, T=T, dil=dil), None),
                    lambda w, T, dil, B: (p1.taps_plain(key, w, B=B, T=T, dil=dil), None),
                    PROBE_F32_TOL)
        if kind in ("resident", "streamed"):
            kern, plain = getattr(pb, kind), getattr(pb, f"{kind}_plain")
            return (lambda w, T, dil, B, **kw: kern(w, B=B, T=T, dil=dil, **kw),
                    lambda w, T, dil, B: plain(w, B=B, T=T, dil=dil), PROBE_BF16_TOL)
        return (lambda w, T, dil, B: p4.body2(w, key, B=B, T=T, dil=dil),
                lambda w, T, dil, B: p4.body2_plain(w, key, B=B, T=T, dil=dil), PROBE_BF16_TOL)

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
        got = kern(w, T, dil, B)
        want, p_ms = events_ms(lambda: plain(w, T, dil, B))
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
        if kind == "streamed":
            report[(kind, key)]["graph_us"] = p3_graph_us
            print(f"probe streamed [{card}]: the call's CUDA graph (a step, replayed {T} "
                  f"times) takes {p3_graph_us:.0f} us to capture and instantiate, inside the "
                  f"timed call; without it {t['ms'] - p3_graph_us / 1e3:.2f} ms", flush=True)

    probe_profile(pb, w_body, dil, B, card)

    # (iii) the checks that can fail, at SHORT_T, with corrupted variants, at
    # every batch size of PROBE_CHECK_BS: P1's clusters (one a row, 15 at
    # once on an H100) and P2-P4's n-tiles of 8 rows change at those edges.
    gen = np.random.RandomState(1)
    short_w = {g: torch.from_numpy((gen.randn(p1.R, p1.R) * g / math.sqrt(p1.R)).astype(
        np.float32)).to(dev) for g in (0.6, 0.3)}
    cond_gen = np.random.RandomState(2)
    short_cond = {b: torch.from_numpy(cond_gen.rand(SHORT_T, b, pb.C).astype(np.float32)).to(dev)
                  for b in PROBE_CHECK_BS}
    t_check = time.perf_counter()
    for (kind, key) in timed:
        kern, plain, tol = runs(kind, key)
        name = f"{kind}[{key}]" if key is not None else kind
        r = report[(kind, key)]
        for Bc in PROBE_CHECK_BS:
            T = SHORT_T
            if kind == "taps":
                # the probe's w underflows; gain 0.6 / sqrt(R) keeps h alive over
                # 65 x 24 layers without chaos, compute (3h) at 0.3 over 8 steps
                w = short_w[0.3 if key == "compute" else 0.6]
                T = 8 if key == "compute" else SHORT_T
            else:
                w = dict(w_b2, cond_in=short_cond[Bc]) if kind == "body2" else w_body
            want = plain(w, T, dil, Bc)
            rel, absd = errs(kern(w, T, dil, Bc), want)
            bad = {}
            if kind == "taps" and key != "dynamic":
                wz = w.clone()
                wz[:, 5] = 0
                bad["w column 5 zeroed"] = kern(wz, T, dil, Bc)
            else:
                bad["layer 23 at half its dilation"] = kern(w, T, bad_dil, Bc)
            if kind == "resident":
                bad["P3's cond rule"] = kern(w, T, dil, Bc, cond_rule="layer")
            if kind == "streamed":
                bad["P2's cond rule"] = kern(w, T, dil, Bc, cond_rule="step")
            bad_rel = {what: errs(out, want)[0] for what, out in bad.items()}
            print(f"probe check {name} [{card}] B={Bc} T={T}: rel err {rel:.3e} (limit {tol}), "
                  f"max abs err {absd:.3e}, ref rms {want[0].pow(2).mean().sqrt().item():.3e}; "
                  "corrupted: " + ", ".join(f"{k} {v:.3e}" for k, v in bad_rel.items()),
                  flush=True)
            check(rel <= tol, f"probe {name} kernel vs plain at B={Bc}, T={T}: {rel}")
            for what, v in bad_rel.items():
                check(v > tol, f"the probe check of {name} at B={Bc} passes a kernel with {what}")
            r["max_abs_err"] = max(r["max_abs_err"], absd)
            r["rel_err"] = max(r["rel_err"], rel)
        r["launches"] = launches[(kind, key)]
        r["us_per_step"] = timed[(kind, key)]["us_per_step"]
    print(f"probe checks [{card}]: {time.perf_counter() - t_check:.1f} s", flush=True)

    # P2 and P3 at the probes' constants, with each other's cond rule
    for kind, wrong in (("resident", "layer"), ("streamed", "step")):
        kern, _, tol = runs(kind, None)
        v = errs(kern(w_body, pb.T, dil, B, cond_rule=wrong), wants[kind])[0]
        print(f"probe check {kind} [{card}] T={pb.T}: the other's cond rule {v:.3e} "
              f"(limit {tol})", flush=True)
        check(v > tol, f"the {kind} check passes the other probe's cond rule at T={pb.T}")
    probe_ablation(card, dev)
    from dvc_tpu_torch.tools import bench_sync
    print(f"exchange primitives [{card}]: {bench_sync.report(bench_sync.measure(dev))}",
          flush=True)
    return report


def probe_plans(card, dev, p1, pb, dil):
    """The probe kernels' plans on the card, held to the plans their
    wrappers compute on the host: P1's cluster (size, channels and shared
    memory a CTA, clusters at once), body_mma's tiles, resident layers and
    shared memory at each batch size of the checks, with and without the
    head, and P3's two kernels' tiles, weight bytes and shared memory, with
    a block of each fitting on one SM (registers too), and the L2."""
    mine = p1.cluster_plan(p1.R, p1.ring_slots(dil))
    got = p1.device_plan(p1.R, p1.ring_slots(dil), dev)
    print(f"probe plan P1 [{card}]: {json.dumps(got)}", flush=True)
    check(all(got[k] == mine[k] for k in ("cluster", "cols", "threads", "smem_bytes")),
          f"P1's plan on the card {got} is not the host's {mine}")
    check(got["max_active_clusters"] >= 1, "no P1 cluster fits on the card")
    for b in PROBE_CHECK_BS:
        for head, rule in ((False, "step"), (True, "input")):
            mine = pb.body_plan(b, pb.L, pb.R, pb.G, pb.S, pb.C, head=head, cond_rule=rule)
            got = pb.device_plan(b, pb.L, pb.R, pb.G, pb.S, pb.C, head=head, cond_rule=rule,
                                 device=dev)
            print(f"probe plan body_mma [{card}] B={b} head={int(head)}: {json.dumps(got)}",
                  flush=True)
            check(all(got[k] == mine[k] for k in got if k != "blocks_per_sm"),
                  f"body_mma's plan on the card {got} is not the host's {mine}")
            check(got["blocks_per_sm"] >= 1, "body_mma does not fit on an SM")
    sp = pb.streamed_plan(8, pb.L, pb.R, pb.G, pb.S, pb.C)
    step_mb = pb.L * (sp["in_ctas"] * sp["in_bytes"] + sp["ctas"] * sp["out_bytes"]) / 1e6
    for b in PROBE_CHECK_BS:
        mine = pb.streamed_plan(b, pb.L, pb.R, pb.G, pb.S, pb.C)
        got = pb.streamed_device_plan(b, pb.L, pb.R, pb.G, pb.S, pb.C, device=dev)
        print(f"probe plan P3 [{card}] B={b}: {json.dumps(got)}; a step's weights {step_mb:.2f} "
              f"MB against the L2's {got['l2_bytes'] / 1e6:.2f} MB (largest persisting window "
              f"{got['persisting_l2_bytes'] / 1e6:.2f} MB)", flush=True)
        check(all(got[k] == mine[k] for k in ("ctas", "in_ctas", "threads", "rows_in",
                                              "rows_out", "in_bytes", "out_bytes", "smem_in",
                                              "smem_out")),
              f"P3's plan on the card {got} is not the host's {mine}")
        check((got["sm_smem"], got["reserved_smem"]) == (pb.SM_SMEM, pb.RESERVED_SMEM),
              f"an SM's shared memory {got['sm_smem']} and reservation {got['reserved_smem']} "
              f"are not the host plan's {pb.SM_SMEM} and {pb.RESERVED_SMEM}")
        check(got["pair_fits"] == 1, f"a block of streamed_in and one of streamed_out do not "
                                     f"fit on one SM at B = {b}: {got}")


def probe_ablation(card, dev):
    """tools/ablate_body once: P2's and P3's split by variant at B = 8, T =
    200, and the per-layer costs it implies."""
    from dvc_tpu_torch.tools import ablate_body
    from dvc_tpu_torch.tools import bench_body as pb

    t0 = time.perf_counter()
    us = ablate_body.ablate(T=200, device=dev)
    base = us["base"]["P2"]
    split = {"in": (base - us["no_in"]["P2"]) / pb.L, "out": (base - us["no_out"]["P2"]) / pb.L,
             "barrier": us["barriers"]["P2"] / (2 * pb.L),
             "staging": (base - us["no_stage"]["P2"]) / pb.L,
             "weights": (base - us["no_weights"]["P2"]) / pb.L}
    print(f"probe ablation [{card}] P2 B={pb.B} T=200: base {base:.2f} us a step; us a layer: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f" (a barrier: barriers only / {2 * pb.L}); {time.perf_counter() - t0:.1f} s",
          flush=True)
    p3 = us["base"]["P3"]
    split3 = {k: (p3 - us[v]["P3"]) / pb.L for k, v in (
        ("in", "no_in"), ("out", "no_out"), ("staging", "no_stage"), ("weights", "no_weights"))}
    print(f"probe ablation [{card}] P3 B={pb.B} T=200: base {p3:.2f} us a step, launches only "
          f"{us['barriers']['P3']:.2f} ({us['barriers']['P3'] / (2 * pb.L):.2f} us a launch); us "
          "a layer: " + ", ".join(f"{k} {v:.2f}" for k, v in split3.items()), flush=True)

TERM_RTOL = 1e-5        # phase 8, card step against CPU step: the limits of
GRAD_RTOL = 1e-3        # tests/test_torch_port_train.py (loss terms; each gradient
PRE_BN_BIAS_SHARE = 1e-4  # over its max |g|; conv biases ahead of a train-mode BN,
STATS_ATOL = 1e-5       # whose exact gradient is 0, over their weight's; BN stats)
GL_ONE_RTOL = 1e-4      # phase 9, card against CPU: Griffin-Lim after one iteration,
                        # max |diff| over max |ref|: 5.4e-7 read on the card, 4.5e-7
                        # between float32 and float64 on the CPU (PERF.md section 6)
RESAMPLE_ATOL = 2e-6    # resample_poly: the limit of tests/test_torch_port_griffinlim.py
GL_SC_RTOL = 0.1        # after 32 iterations the phase is chaotic at float32 resolution:
                        # a 1e-7 relative change of the magnitude moves the waveform by up
                        # to 0.97 of its peak and its spectral convergence by 4% (CPU, PERF.md
                        # section 6); the card's and the CPU's spectral convergence are held
                        # within 10% of each other, and under half of the zero-phase start's
BENCH_BATCH, BENCH_FRAMES = 256, 64  # bench.py:40-41, the repo's train workload
TRAIN_BATCH = 8         # training.sh
MEL_CARD_ATOL = 1e-4    # phase 10, preprocess mels card against CPU, of the [0, 1] range:
                        # cuFFT against pocketfft, float32 (tests hold the CPU to
                        # dvc_tpu at 1e-5)
MCD_CARD_ATOL = 1e-3    # phase 10, per-utterance MCD card against CPU, dB (the limit
                        # of tests/test_torch_port_mcd.py against dvc_tpu)
RECIPE_SPEAKERS = ("p225", "p226", "p227", "p228")  # p228 recorded at 48 kHz


def make_corpus(mel_dir, dev, acfg, n_utts, seconds):
    """A synthetic 2-speaker mel corpus made with the port's melspectrogram:
    sines at 140 + 90 (speaker) + 25 (utterance) Hz, seconds(utterance) long."""
    from dvc_tpu_torch.ops.mel import melspectrogram
    for si, spk in enumerate(("spkA", "spkB")):
        os.makedirs(os.path.join(mel_dir, spk))
        for ui in range(n_utts):
            tt = np.arange(int(acfg.sample_rate * seconds(ui))) / acfg.sample_rate
            wav = 0.4 * np.sin(2 * np.pi * (140 + 90 * si + 25 * ui) * tt)
            with torch.inference_mode():
                mel = melspectrogram(torch.tensor(wav, dtype=torch.float32, device=dev), acfg)
            np.save(os.path.join(mel_dir, spk, f"{spk}_{ui:03d}_mel.npy"), mel.cpu().numpy())


def device_busy_us(prof) -> float:
    """Microseconds in which at least one kernel ran: the union of the
    device events' intervals (kernels on several streams overlap, so their
    summed times can exceed the wall time)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def step_against_cpu(cfg, dev):
    """One float32 train step at full width on the card and on the CPU from
    the same weights, batch and injected noise, TF32 off: (loss terms err,
    worst gradient err, worst pre-BN bias share, worst BN stat err)."""
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.train.trainer import make_optimizer, make_train_step
    rng = np.random.RandomState(11)
    v = cfg.vae
    x1, x2 = (torch.from_numpy(rng.rand(TRAIN_BATCH, v.num_mels, v.frames).astype(np.float32))
              for _ in range(2))
    eps = [torch.from_numpy(rng.randn(TRAIN_BATCH, n).astype(np.float32))
           for n in (v.content_size, v.content_size, v.speaker_size)]
    cpu = seeded(lambda: DisentangledVAE(v, pair_fused=True), SEED + 6).train()
    card = copy.deepcopy(cpu).to(dev)
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        step = make_train_step(model, make_optimizer(model, 1e-4), compute_dtype="float32")
        terms = step(x1.to(d), x2.to(d), eps=tuple(e.to(d) for e in eps))
        out[name] = (terms, {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {n: b.cpu() for n, b in model.named_buffers() if "running" in n})
    (t_c, g_c, s_c), (t_g, g_g, s_g) = out["cpu"], out["card"]
    term_err = max(abs(a.item() - b.item()) / max(abs(a.item()), 1e-12)
                   for a, b in zip(t_c, t_g))
    grad_err, bias_share = vae_grad_errs(g_c, g_g)
    stat_err = max((s_c[n] - s_g[n]).abs().max().item() for n in s_c)
    return term_err, grad_err, bias_share, stat_err, t_c.total.item()


def vae_pre_bn_bias(name: str) -> bool:
    return name.endswith("conv.bias") or (name.startswith("dec_modules")
                                          and name.endswith(".0.bias"))


def autovc_pre_bn_bias(name: str) -> bool:
    """The decoder's and postnet's conv biases; the encoder's reach the
    content term through the updated running statistics and are held like
    any other gradient."""
    return name.endswith("conv.bias") and not name.startswith("encoder.")


def vae_grad_errs(g_c, g_g, pre_bn_bias=vae_pre_bn_bias) -> tuple[float, float]:
    """(worst max |diff| over max |g| of a model's gradients, name -> CPU
    tensor, against the reference g_c; the worst share of a pre-BN conv
    bias's gradient, exactly 0 in exact arithmetic, in its weight's).
    pre_bn_bias(name) picks those biases, the VAE's by default."""
    grad_err, bias_share = 0.0, 0.0
    for n, a in g_c.items():
        b = g_g[n]
        if pre_bn_bias(n):
            w = g_c[n[:-len("bias")] + "weight"].abs().max().item()
            bias_share = max(bias_share, max(a.abs().max().item(), b.abs().max().item()) / w)
            continue
        grad_err = max(grad_err, (a - b).abs().max().item() / a.abs().max().item())
    return grad_err, bias_share


def train_phase(card, dev, work):
    """Phase 8: the VAE training path at full width.  Returns (mel_dir,
    log_dir) for phase 9 and the bench step's ms and memory for phase 12."""
    from dvc_tpu_torch.config import AudioConfig, Config, TrainConfig
    from dvc_tpu_torch.data.dataset import PairedMelDataset
    from dvc_tpu_torch.train.checkpoint import latest_checkpoint_step
    from dvc_tpu_torch.train.trainer import Trainer
    acfg = AudioConfig()
    mel_dir, log_dir = os.path.join(work, "mels8"), os.path.join(work, "run8")
    # phase 3's recipe, 16 utterances a speaker of 1.2-1.95 s (70-125 frames,
    # so the 64-frame crops move): 16 same-speaker pairs, batch 8 is real
    make_corpus(mel_dir, dev, acfg, 16, lambda ui: 1.2 + 0.05 * ui)
    cfg = Config(train=TrainConfig(batch_size=TRAIN_BATCH, seed=SEED))
    # (i) the main path: Trainer.run_training, the defaults (compute_dtype
    # bfloat16, pair_fused), a checkpoint at the last epoch
    epochs = 4
    trainer = Trainer(cfg, checkpoints_path=os.path.join(log_dir, "checkpoints"), device=dev)
    ds = PairedMelDataset(mel_dir, samples_length=cfg.vae.frames, seed=SEED)
    t0 = time.perf_counter()
    hist = trainer.run_training(ds, epochs, report_interval=epochs,
                                logging_func=lambda m: print(f"train [{card}] {m}", flush=True))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    found = latest_checkpoint_step(os.path.join(log_dir, "checkpoints"))
    check(all(math.isfinite(h["total"]) for h in hist), f"train loss not finite: {hist}")
    check(found is not None and found[0] == epochs, f"no checkpoint of epoch {epochs}: {found}")
    check(os.path.exists(found[1][: -len(".pth")] + ".opt.pth"), "no optimizer checkpoint")
    # the loss on one fixed batch falls over 10 more steps
    x1, x2, _ = next(iter(ds.batches(TRAIN_BATCH)))
    x1, x2 = (torch.from_numpy(a).to(dev) for a in (x1, x2))
    fixed = [trainer.step_on(x1, x2).total.item() for _ in range(10)]
    check(all(math.isfinite(f) for f in fixed) and fixed[-1] < fixed[0],
          f"loss does not fall on a fixed batch: {fixed}")
    print(f"train main path [{card}]: run_training {epochs} epochs x {len(ds) // TRAIN_BATCH} "
          f"steps at batch {TRAIN_BATCH} in {run_s:.1f} s, epoch losses "
          f"{[round(h['total'], 2) for h in hist]}; checkpoint {os.path.basename(found[1])}; "
          f"fixed batch over 10 steps {fixed[0]:.2f} -> {fixed[-1]:.2f}", flush=True)

    # (ii) one float32 step on the card against the same step on the CPU
    t0 = time.perf_counter()
    term_err, grad_err, bias_share, stat_err, total = step_against_cpu(cfg, dev)
    print(f"train step card vs CPU [{card}] full width, float32, batch {TRAIN_BATCH}, TF32 off "
          f"({time.perf_counter() - t0:.1f} s): loss {total:.3f}; loss terms rel err "
          f"{term_err:.3e} (limit {TERM_RTOL}), gradients rel err {grad_err:.3e} (limit "
          f"{GRAD_RTOL}), pre-BN conv biases' gradient share {bias_share:.3e} (limit "
          f"{PRE_BN_BIAS_SHARE}), BN running stats max err {stat_err:.3e} (limit {STATS_ATOL})",
          flush=True)
    check(term_err <= TERM_RTOL, f"card step loss terms differ from the CPU's: {term_err}")
    check(grad_err <= GRAD_RTOL, f"card step gradients differ from the CPU's: {grad_err}")
    check(bias_share <= PRE_BN_BIAS_SHARE, f"pre-BN bias gradients not ~0: {bias_share}")
    check(stat_err <= STATS_ATOL, f"card step BN statistics differ from the CPU's: {stat_err}")

    # (iii) steady-state steps at bench.py's batch, the default config
    del trainer
    torch.cuda.empty_cache()
    bench = Trainer(Config(train=TrainConfig(batch_size=BENCH_BATCH, seed=SEED)), device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    xb1, xb2 = (torch.rand(BENCH_BATCH, 80, BENCH_FRAMES, device=dev, generator=g)
                for _ in range(2))
    for _ in range(3):
        bench.step_on(xb1, xb2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9  # weights, Adam, batch, earlier phases
    iters = 20
    _, ms = events_ms(lambda: [bench.step_on(xb1, xb2) for _ in range(iters)])
    loss = bench.step_on(xb1, xb2).total.item()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_ms = ms / iters
    fps = 2 * BENCH_BATCH * BENCH_FRAMES / (step_ms / 1e3)
    check(math.isfinite(loss), "bench step loss not finite")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, p_ms = events_ms(lambda: [bench.step_on(xb1, xb2) for _ in range(3)])
    kern = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(k[1] for k in kern)
    busy_us = device_busy_us(prof)
    top = sorted(kern, key=lambda k: -k[1])[:8]
    print(f"train step [{card}] batch {BENCH_BATCH} x {BENCH_FRAMES} frames, bfloat16 inputs, "
          f"float32 compute (TF32 off), pair_fused: {step_ms:.2f} ms a step (mean of {iters}), "
          f"{fps:.1f} mel frames/s, peak memory {peak_gb:.2f} GB ({peak_gb - held_gb:.2f} GB "
          f"above the {held_gb:.2f} GB allocated before the steps)", flush=True)
    if busy_us > 0:
        print(f"train step profile [{card}] 3 steps, {p_ms:.1f} ms: kernel time "
              f"{kernel_us / 1e3:.1f} ms summed over streams, device busy (union of kernel "
              f"intervals) {busy_us / 1e3:.1f} ms (idle share {1 - busy_us / (p_ms * 1e3):.3f}); "
              "top kernels by device time: " + "; ".join(
                  f"{k[:60]} {us / 1e3:.1f} ms x {n}" for k, us, n in top), flush=True)
    else:
        print(f"train step profile [{card}]: no device time recorded (not measured)",
              flush=True)
    del bench
    torch.cuda.empty_cache()
    return mel_dir, log_dir, {"ms": step_ms, "peak_gb": peak_gb, "held_gb": held_gb}


def start_serve(args, port, device, log_path):
    """``python -m dvc_tpu_torch.cli.run serve`` in a child process on
    ``device``, its output in log_path; returns it once /health answers."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "dvc_tpu_torch.cli.run", "serve", *args,
                                 "--port", str(port), "--device", str(device)], cwd=root,
                                env=env, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(log_path) as log:
                raise SystemExit(f"chip_smoke: FAILED: serve exited {proc.returncode}: "
                                 f"{log.read()[-2000:]}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                if r.status == 200:
                    return proc
        except OSError:
            time.sleep(0.5)
    stop(proc)
    raise SystemExit("chip_smoke: FAILED: serve did not answer /health in 300 s")


def stop(proc):
    proc.terminate()
    try:
        proc.wait(30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request_body(sr, seed) -> bytes:
    """A 0.5 s request wav at sr Hz: a tone of 170 + 20 seed Hz over noise."""
    from dvc_tpu_torch.utils.wavio import wav_bytes
    tt = np.arange(sr // 2) / sr
    rng = np.random.RandomState(seed)
    return wav_bytes((0.3 * np.sin(2 * np.pi * (170 + 20 * seed) * tt)
                      + 0.01 * rng.randn(len(tt))).astype(np.float32), sr)


def post_convert(url, data):
    """POST /convert?trg_spk=spkB: (status, body, seconds)."""
    req = urllib.request.Request(f"{url}/convert?trg_spk=spkB", data=data, method="POST")
    t_req = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), time.perf_counter() - t_req


def serve_phase(card, dev, mel_dir, log_dir):
    """Phase 9: the serving defaults.  `serve` with the default Griffin-Lim
    vocoder on phase 8's checkpoint answers concurrent POST /convert, one
    at 22.05 kHz; `serve --profile_transfer` answers too; Griffin-Lim and
    resample_poly on the card against the CPU."""
    from dvc_tpu_torch.config import AudioConfig
    from dvc_tpu_torch.convert import griffinlim as gl
    from dvc_tpu_torch.ops.audio import resample_poly
    from dvc_tpu_torch.utils.wavio import parse_wav
    acfg = AudioConfig()
    body, post = request_body, post_convert

    # 0.5 s at 16 kHz -> 33 mel frames -> one 64-frame chunk -> Griffin-Lim
    want_len = gl.default_inversion_length(BENCH_FRAMES, acfg)
    routes = (("default (Griffin-Lim, phase 8's checkpoint)",
               ["--dataset_fp", mel_dir, "--log_dir", log_dir, "--max_wait_ms", "500"],
               (16000, 22050, 16000)),
              ("--profile_transfer", ["--dataset_fp", mel_dir, "--profile_transfer",
                                      "--max_wait_ms", "500"], (44100, 16000)))
    for name, args, rates in routes:
        port = free_port()
        t0 = time.perf_counter()
        proc = start_serve(args, port, dev.type, os.path.join(log_dir, f"serve_{port}.log"))
        up_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        try:
            post(url, body(16000, 99))  # warm-up: cuDNN plans, cuFFT plans
            with ThreadPoolExecutor(len(rates)) as pool:
                replies = list(pool.map(lambda a: post(url, body(*a)),
                                        [(sr, i) for i, sr in enumerate(rates)]))
            with urllib.request.urlopen(url + "/stats", timeout=60) as r:
                stats = json.loads(r.read())
        finally:
            stop(proc)
        for (status, data, _), sr in zip(replies, rates):
            wav, out_sr = parse_wav(data)
            check(status == 200 and out_sr == acfg.sample_rate,
                  f"serve {name}: reply {status} at {out_sr} Hz for a {sr} Hz body")
            check(np.isfinite(wav).all() and wav.std() > 1e-3,
                  f"serve {name}: reply for a {sr} Hz body not a finite moving wav")
            if "profile" not in name:
                check(wav.shape == (want_len,), f"serve {name}: reply {wav.shape} for {sr} Hz")
        lat = sorted(r[2] for r in replies)
        print(f"serve {name} [{card}]: up in {up_s:.1f} s; {len(rates)} concurrent POST "
              f"/convert of 0.5 s at {list(rates)} Hz answered 200 with 16 kHz wavs of "
              f"{[len(parse_wav(r[1])[0]) for r in replies]} samples; latency min "
              f"{lat[0]:.3f} s, max {lat[-1]:.3f} s; {stats['requests']} requests in "
              f"{stats['batches']} batches", flush=True)

    # Griffin-Lim and resampling, card against CPU
    mel = np.load(os.path.join(mel_dir, "spkA", "spkA_000_mel.npy"))
    mags = {d: gl.mel_to_stft_magnitude(torch.from_numpy(mel).to(d), acfg)
            for d in ("cpu", dev)}
    length = gl.default_inversion_length(mel.shape[1], acfg)

    def spectral_convergence(wav):
        """|| |STFT(wav)| - mag || / || mag ||, Griffin-Lim's objective."""
        m = mags["cpu"].double()
        return ((gl._stft_complex(torch.from_numpy(wav).double(), acfg).abs() - m).norm()
                / m.norm()).item()

    one = {d: gl.griffin_lim(mags[d], acfg, 1) for d in mags}
    gl_err = rel_err(torch.from_numpy(one[dev]), torch.from_numpy(one["cpu"]))
    t0 = time.perf_counter()
    want = gl.griffin_lim(mags["cpu"], acfg, 32)
    c_ms = (time.perf_counter() - t0) * 1e3
    gl.griffin_lim(mags[dev], acfg, 32)
    got, g_ms = events_ms(lambda: gl.griffin_lim(mags[dev], acfg, 32))
    sc0 = spectral_convergence(gl.griffin_lim(mags["cpu"], acfg, 0))
    sc_c, sc_g = spectral_convergence(want), spectral_convergence(got)
    rng = np.random.RandomState(12)
    w22 = torch.from_numpy((rng.randn(22050) * 0.3).astype(np.float32))
    r_want = resample_poly(w22, 22050, 16000)
    w22d = w22.to(dev)
    resample_poly(w22d, 22050, 16000)
    r_got, r_ms = events_ms(lambda: resample_poly(w22d, 22050, 16000))
    r_err = (r_got.cpu() - r_want).abs().max().item()
    print(f"griffin_lim card vs CPU [{card}] {mel.shape[1]} frames -> {length} samples: one "
          f"iteration rel err {gl_err:.3e} (limit {GL_ONE_RTOL}); 32 iterations: card {g_ms:.1f} "
          f"ms, CPU {c_ms:.1f} ms, spectral convergence card {sc_g:.4f}, CPU {sc_c:.4f} "
          f"(limit {GL_SC_RTOL} apart), zero-phase start {sc0:.4f}, waveform rel diff "
          f"{rel_err(torch.from_numpy(got), torch.from_numpy(want)):.3e} (reported). "
          f"resample_poly 22050 -> 16000 Hz, 1 s: max abs err {r_err:.3e} (limit "
          f"{RESAMPLE_ATOL}); card {r_ms:.2f} ms", flush=True)
    check(one[dev].shape == one["cpu"].shape == (length,) and gl_err <= GL_ONE_RTOL,
          f"Griffin-Lim card vs CPU after one iteration {gl_err}")
    check(got.shape == want.shape and abs(sc_g - sc_c) <= GL_SC_RTOL * sc_c
          and max(sc_g, sc_c) < 0.5 * sc0,
          f"Griffin-Lim spectral convergence card {sc_g}, CPU {sc_c}, start {sc0}")
    check(r_got.shape == r_want.shape and r_err <= RESAMPLE_ATOL,
          f"resample_poly card vs CPU {r_err}")


def recipe_corpus(root: str) -> dict[str, float]:
    """Phase 10's VCTK-layout corpus under root/VCTK-Corpus/wav16: per
    speaker 12 utterances of 2-4 s, two voiced stretches (harmonics of a
    moving f0 up to 7.9 kHz) around a 0.5-1 s silent gap, over a noise
    floor of std 0.01; the last speaker at 48 kHz.  Returns each file's
    seconds."""
    from dvc_tpu_torch.utils.wavio import write_wav
    rng = np.random.RandomState(SEED + 20)
    seconds = {}
    for si, spk in enumerate(RECIPE_SPEAKERS):
        sr = 48000 if si == 3 else 16000
        d = os.path.join(root, "VCTK-Corpus", "wav16", spk)
        os.makedirs(d)
        for u in range(12):
            total, gap = rng.uniform(2.0, 4.0), rng.uniform(0.5, 1.0)
            first = rng.uniform(0.3, 0.7) * (total - gap)
            n = int(sr * total)
            t = np.arange(n) / sr
            f0 = 95 + 30 * si + 4 * u + 25 * np.sin(2 * np.pi * rng.uniform(0.4, 1.2) * t)
            ph = (2 * np.pi * np.cumsum(f0) / sr).astype(np.float32)
            h = np.arange(1, 70, dtype=np.float32)[:, None]
            voice = ((0.3 / h) * np.sin(h * ph[None] + rng.uniform(0, 6.3, (69, 1)).astype(
                np.float32)) * (h * f0[None].astype(np.float32) < 7900)).sum(0)
            voice[int(sr * first):int(sr * (first + gap))] = 0.0
            wav = (voice + 0.01 * rng.randn(n)).astype(np.float32)
            path = os.path.join(d, f"{spk}_{u:03d}.wav")
            write_wav(path, wav, sr)
            seconds[path] = n / sr
    return seconds


class Children:
    """``python -m dvc_tpu_torch.cli.run <args> --device cuda`` as child
    processes, started at once and waited for by name; any still running
    when the phase ends or fails is killed."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=self.root + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.jobs = {}

    def start(self, name, args):
        log_path = os.path.join(self.log_dir, f"{name}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "dvc_tpu_torch.cli.run", *args,
                                     "--device", "cuda"], cwd=self.root, env=self.env,
                                    stdout=log, stderr=subprocess.STDOUT)
        t0, ended = time.perf_counter(), []
        watcher = threading.Thread(target=lambda: ended.append((proc.wait(),
                                                                time.perf_counter())),
                                   daemon=True)
        watcher.start()
        self.jobs[name] = (proc, log_path, t0, watcher, ended)

    def wait(self, name):
        """(output, seconds from start to exit); fails with the output's
        tail unless the child exited 0.  The exit is timed by a thread
        waiting on the child, so a child that ended before this call is
        not timed to it."""
        proc, log_path, t0, watcher, ended = self.jobs.pop(name)
        watcher.join(900)
        if watcher.is_alive():
            proc.kill()
            watcher.join(30)
        rc, secs = (ended[0][0], ended[0][1] - t0) if ended else (None, float("nan"))
        with open(log_path) as log:
            out = log.read()
        check(rc == 0, f"`{name}` exited {rc}: {out[-3000:]}")
        return out, secs

    def kill_all(self):
        for proc, _, _, watcher, _ in self.jobs.values():
            if proc.poll() is None:
                proc.kill()
            watcher.join(30)
        self.jobs.clear()


def recipe_phase(card, dev, work):
    """Phase 10: the verify recipe (preprocess -> train -> convert ->
    eval-mcd) through the CLI on the card at full width, held against the
    port's CPU runs, in the directory work (phase 11 reuses its corpus and
    run).  Independent children run at once, beside the in-process CPU
    references."""
    kids = Children(work)
    try:
        recipe_steps(card, dev, work, kids)
    finally:
        kids.kill_all()


def recipe_steps(card, dev, work, kids):
    import shutil

    from dvc_tpu_torch.cli import run as cli
    from dvc_tpu_torch.config import AudioConfig, Config, TrainConfig, VocoderConfig
    from dvc_tpu_torch.data.preprocess import preprocess_dataset, preprocess_wav_host
    from dvc_tpu_torch.eval.mcd import analyze_wavs, evaluate_mcd_wav
    from dvc_tpu_torch.kernels import wavenet_step as ws
    from dvc_tpu_torch.models.wavenet import WaveNet
    from dvc_tpu_torch.ops.audio import gmm_vad_mask
    from dvc_tpu_torch.train.trainer import Trainer
    from dvc_tpu_torch.utils import msgpack
    from dvc_tpu_torch.utils.convert import wavenet_tree_from_state_dict
    from dvc_tpu_torch.utils.wavio import read_wav
    acfg = AudioConfig()
    t0 = time.perf_counter()
    vctk = os.path.join(work, "vctk")
    seconds = recipe_corpus(vctk)
    audio_s = sum(seconds.values())
    wav16 = os.path.join(vctk, "VCTK-Corpus", "wav16")
    print(f"recipe corpus [{card}]: {len(seconds)} wavs, {audio_s:.1f} s of audio "
          f"({time.perf_counter() - t0:.1f} s to write)", flush=True)

    # 2. preprocess, with the gmm VAD trim and with --no_trim, as two children
    # at once; meanwhile the same on the CPU here, and the VAD masks
    tags = {"trim": [], "no_trim": ["--no_trim"]}
    for tag, flag in tags.items():
        kids.start(f"preprocess_{tag}", ["preprocess", vctk, "-o",
                                         os.path.join(work, f"mels_{tag}"), "-d", "VCTK", *flag])
    t0 = time.perf_counter()
    for tag in tags:
        preprocess_dataset(vctk, os.path.join(work, f"mels_{tag}_cpu"), "VCTK",
                           trim=tag == "trim", device="cpu")
    cpu_s = time.perf_counter() - t0
    t_card, n_voiced, n_win = 0.0, 0, 0
    for path in sorted(seconds):
        w = torch.from_numpy(preprocess_wav_host(path, acfg, trim=False, device="cpu"))
        t1 = time.perf_counter()
        m_card = gmm_vad_mask(w.to(dev))
        t_card += time.perf_counter() - t1
        m_cpu = gmm_vad_mask(w)
        check(torch.equal(m_card, m_cpu), f"gmm VAD mask card != CPU for {path}")
        n_voiced += int(m_cpu.sum())
        n_win += m_cpu.numel()
    print(f"gmm VAD [{card}]: masks on the card equal the CPU's for all {len(seconds)} "
          f"files ({n_voiced} of {n_win} windows voiced); card {t_card:.2f} s "
          f"({audio_s / t_card:.1f} s of audio a second: band features on the card, "
          "the frame recurrence on the host; beside the preprocess children)", flush=True)
    frames = {}
    for tag in tags:
        said, secs = kids.wait(f"preprocess_{tag}")
        check(f"preprocessed {len(seconds)} files" in said,
              f"preprocess {tag}: {said.strip()[-300:]}")
        out, ref = os.path.join(work, f"mels_{tag}"), os.path.join(work, f"mels_{tag}_cpu")
        err, frames[tag] = 0.0, 0
        for spk in RECIPE_SPEAKERS:
            names = sorted(os.listdir(os.path.join(out, spk)))
            check(names == sorted(os.listdir(os.path.join(ref, spk))) and len(names) == 13,
                  f"preprocess {tag}: {spk} holds {names}")
            with open(os.path.join(out, spk, "_sources.txt")) as f:
                check(len(f.read().splitlines()) == 12, f"{spk}/_sources.txt")
            for n in names[1:]:
                a, b = np.load(os.path.join(out, spk, n)), np.load(os.path.join(ref, spk, n))
                check(a.shape == b.shape and a.shape[0] == 80 and a.dtype == np.float32
                      and 0.0 <= a.min() and a.max() <= 1.0,
                      f"preprocess {tag}: {n} {a.shape} {b.shape} [{a.min()}, {a.max()}]")
                err = max(err, float(np.abs(a - b).max()))
                frames[tag] += a.shape[1]
        print(f"preprocess {tag} [{card}]: `preprocess` child process {secs:.1f} s for "
              f"{audio_s:.1f} s of audio ({audio_s / secs:.1f} s of audio a second, process "
              f"start included, the other preprocess child beside it), {frames[tag]} mel "
              f"frames; card mels against the CPU (both CPU runs {cpu_s:.1f} s in this "
              f"process): max abs err {err:.3e} (limit {MEL_CARD_ATOL})", flush=True)
        check(err <= MEL_CARD_ATOL, f"preprocess {tag}: card mels against CPU {err}")
    check(frames["trim"] < frames["no_trim"],
          f"the VAD trimmed nothing: {frames['trim']} frames of {frames['no_trim']}")

    # 3. train 2 epochs at batch 8 on the --no_trim mels
    mels, run = os.path.join(work, "mels_no_trim"), os.path.join(work, "run")
    kids.start("train", ["train", "--dataset_fp", mels, "--log_dir", run, "--epochs", "2",
                         "--batch-size", "8", "--samples_length", "64",
                         "--report-interval", "2", "--seed", str(SEED)])
    said, secs = kids.wait("train")
    ck = os.path.join(run, "checkpoints")
    have = sorted(os.listdir(ck))
    check(have == [f"DisentangledVAE_VCTK_2{s}" for s in (".msgpack", ".opt.pth", ".pth")],
          f"train wrote {have}")
    alone = os.path.join(work, "alone")
    os.makedirs(alone)
    shutil.copy(os.path.join(ck, "DisentangledVAE_VCTK_2.msgpack"), alone)
    cfg = Config(train=TrainConfig(batch_size=8, seed=SEED))
    a, b = (Trainer(cfg, checkpoints_path=d, device=dev) for d in (alone, ck))
    check(a.load_last() == b.load_last() == 3 and a.step == b.step > 0,
          f"resume: msgpack step {a.step}, .pth step {b.step}")
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        check(torch.equal(pa, pb), f"msgpack and .pth differ in {n}")
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    check(sa.keys() == sb.keys() and all(torch.equal(sa[k][f], sb[k][f]) for k in sb
                                         for f in ("step", "exp_avg", "exp_avg_sq")),
          "msgpack and .opt.pth Adam states differ")
    losses = [ln.strip() for ln in said.splitlines() if "Epoch" in ln]
    print(f"train [{card}]: `train` child process {secs:.1f} s, {losses}; "
          f"{', '.join(have)}; the .msgpack alone resumes to the .pth pair's weights, "
          f"Adam state and step ({a.step})", flush=True)
    del a, b
    torch.cuda.empty_cache()

    # 4. convert: two pairs with Griffin-Lim as children at once; meanwhile
    # one utterance with the WaveNet from a .msgpack in this process
    common = ["--dataset_fp", mels, "--log_dir", run]
    pairs_gl = (("p225", "p226"), ("p227", "p228"))
    for src, trg in pairs_gl:
        kids.start(f"convert_{src}_{trg}", ["convert", *common, "--src_spk", src,
                                             "--trg_spk", trg, "--num_utterances", "2"])
    voc = os.path.join(work, "wavenet.msgpack")
    wn = seeded(lambda: WaveNet(VocoderConfig()), SEED + 21)
    with open(voc, "wb") as f:
        f.write(msgpack.packb({"params": wavenet_tree_from_state_dict(wn.state_dict())}))
    ws.wavenet_generate.launches.clear()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        check(cli.main(["convert", *common, "--src_spk", "p226", "--trg_spk", "p225",
                        "--num_utterances", "1", "--vocoder_ckpt", voc,
                        "--device", "cuda"]) == 0, "WaveNet convert")
        torch.cuda.synchronize()
    wn_s = time.perf_counter() - t0
    launches = dict(ws.wavenet_generate.launches)
    recs = sum(e.count for e in prof.key_averages() if "wavenet_persistent" in e.key)
    check(recs == 1 and launches == {"bfloat16": 1},
          f"WaveNet convert: {recs} wavenet_persistent records, launches {launches}")
    conv_s = [kids.wait(f"convert_{src}_{trg}")[1] for src, trg in pairs_gl]
    gen = os.path.join(run, "generation")
    wavs = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(gen) for f in fs
                  if f.endswith(".wav"))
    check(len(wavs) == 5, f"convert wrote {wavs}")
    for path in wavs:
        w, sr = read_wav(path)
        check(sr == 16000 and np.isfinite(w).all() and w.std() > 1e-3, f"{path}")
    print(f"convert [{card}]: Griffin-Lim `convert` child processes "
          f"{', '.join(f'{x:.1f}' for x in conv_s)} s for 2 utterances each (at once); "
          f"WaveNet from a .msgpack in this process {wn_s:.1f} s for 1 utterance: {recs} "
          f"wavenet_persistent record, launches {launches}", flush=True)

    # 5. eval-mcd: the Griffin-Lim conversions against their sources, and
    # two sources against themselves (named <utt>_cv.wav); meanwhile the
    # same pairs analyzed on the CPU here
    cvt = os.path.join(work, "cvt")
    os.makedirs(cvt)
    for path in wavs:
        if "p226_to_p225" not in path:  # the WaveNet one has random weights
            shutil.copy(path, cvt)
    for stem in ("p225_000", "p227_001"):
        shutil.copy(os.path.join(wav16, stem[:4], f"{stem}.wav"),
                    os.path.join(cvt, f"{stem}_cv.wav"))
    kids.start("eval_mcd", ["eval-mcd", "--src_dir", wav16, "--cvt_dir", cvt])
    pairs = cli._pair_converted_to_source(wav16, cvt)
    t0 = time.perf_counter()
    cpu_mcd = evaluate_mcd_wav([read_wav(s)[0] for s, _ in pairs],
                               [read_wav(c)[0] for _, c in pairs], device="cpu")
    cpu_s = time.perf_counter() - t0
    said, secs = kids.wait("eval_mcd")
    card_mcd = {ln.split()[1]: float(ln.split("mcd: ")[1]) for ln in said.splitlines()
                if ln.startswith("utterance ")}
    check(len(card_mcd) == len(pairs) == 6, f"eval-mcd printed {card_mcd} for {pairs}")
    errs = []
    for (_, c), m in zip(pairs, cpu_mcd):
        got = card_mcd[os.path.basename(c)]
        check(math.isfinite(got), f"MCD of {c} not finite: {got}")
        if c.endswith("_cv.wav"):
            check(got == 0.0 and m == 0.0, f"a source against itself gave {got}, CPU {m}")
        errs.append(abs(got - m))
    print(f"eval-mcd [{card}]: `eval-mcd` child process {secs:.1f} s; MCD "
          f"{json.dumps(card_mcd)}; card against the CPU analysis ({cpu_s:.1f} s, beside "
          f"the child): max abs diff {max(errs):.3e} dB (limit {MCD_CARD_ATOL})", flush=True)
    check(max(errs) <= MCD_CARD_ATOL, f"MCD card against CPU {max(errs)}")

    # 6. the analysis rate, alone: every 16 kHz source through the thread pool
    srcs16 = [p for p in sorted(seconds) if "p228" not in p]
    wav_in = [read_wav(p)[0] for p in srcs16]
    t0 = time.perf_counter()
    feats = analyze_wavs(wav_in, device=dev)
    an_s = time.perf_counter() - t0
    an_audio = sum(seconds[p] for p in srcs16)
    check(all(np.isfinite(mc).all() and len(f0) == len(w) // 80 + 1
              for (f0, mc), w in zip(feats, wav_in)), "analysis not finite")
    print(f"analysis [{card}]: WORLD analysis (Harvest, D4C on the host; CheapTrick, "
          f"sp2mc on the card) of {len(wav_in)} wavs, {an_audio:.1f} s of audio, on up to "
          f"8 threads in {an_s:.2f} s: {an_audio / an_s:.1f} s of audio a second", flush=True)


VOC_STEPS = 300         # phase 11: train-vocoder steps of each child ("a few hundred")
VOC_HELD_BATCHES = 4    # phase 11 (i): batches the checkpoints are held on against init
VOC_CHECK_CROP = 1024   # phase 11 (ii): the WaveNet step held card against CPU, 4 frames
ISTFT_CROP = 31         # train-vocoder --arch istft's crop at the default 8000 samples
UPDATE_RTOL = 1e-3      # phase 11 (ii): each parameter's first Adam/AdamW update on the
                        # card against its formula on the card's own gradient, of lr
EMA_RTOL = 1e-6         # the EMA trail against d e + (1 - d) p, of the parameter's max
ISTFT_F32_GRAD_RTOL = 1e-2  # the iSTFT step's float32 gradients card against CPU, of each
                        # one's max: ~7x the 1.44e-3 read, where the same step in
                        # float64 agrees to 4.5e-12 (PERF.md section 6)
F64_GRAD_RTOL = 1e-6    # the same step in float64 on both, where the conditioning that
                        # float32 hits sits far below this
ISTFT_PEAK_RTOL = 1e-4  # phase 11 (iii): iSTFT synthesis card against CPU, of the peak
TRAINED_NOFB_ATOL = 4e-3  # phase 11 (iv): the bf16 kernel on the trained EMA weights,
TRAINED_NOFB_RMS = 3e-4   # feedback cut, against the open-loop plain version: 2.5-4x
                          # the largest max (1.0e-3) and rms (1.2e-4) errors read over
                          # four trainings, whose weights differ (cuDNN's training is
                          # not deterministic) and whose rms read 1.0e-5 to 1.2e-4
                          # (PERF.md); phase 6 (v)'s limits, far looser here, are
                          # printed beside them
WAVENET_MACS = 24.65e6  # multiply-adds a sample of the full WaveNet's forward (PERF.md)


def layer0_wrong_tap(packed):
    """A pack whose layer 0 reads its ring taps at twice its dilation
    (x_{t-4}, x_{t-2} for x_{t-2}, x_{t-1}), with the ring laid out to match."""
    dil = packed["dil"].copy()
    dil[0] *= 2
    offs = np.concatenate([[0], np.cumsum(2 * dil)[:-1]]).astype(np.int32)
    return dict(packed, dil=dil, offs=offs, slots=int((2 * dil).sum()))


def grads_rel_err(a, b) -> float:
    """Worst max |diff| over max |g| between two models' gradients; a
    parameter whose gradient is 0 (the last layer's residual output feeds
    nothing) must be 0 on both."""
    worst = 0.0
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        ga = None if pa.grad is None else pa.grad.cpu()
        gb = None if pb.grad is None else pb.grad.cpu()
        if ga is None or not ga.any():
            check(gb is None or not gb.any(), f"{n}: gradient 0 on one side only")
            continue
        worst = max(worst, (ga - gb).abs().max().item() / ga.abs().max().item())
    return worst


def vocoder_steps_against_cpu(card, dev, wav_dir):
    """Phase 11 (ii): one train step of each vocoder at full width on the
    card and on the CPU from the same weights and batch (TF32 off); each
    card update against its formula."""
    from dvc_tpu_torch.config import AudioConfig, ISTFTVocoderConfig, VocoderConfig
    from dvc_tpu_torch.models.istft_vocoder import ISTFTVocoder
    from dvc_tpu_torch.train import istft_vocoder_trainer as ivt
    from dvc_tpu_torch.train import vocoder_trainer as vt
    from dvc_tpu_torch.train.trainer import make_optimizer

    # the WaveNet at dropout 0 (the card's and the CPU's generators differ),
    # on a crop of 4 frames the CPU steps in seconds
    t0 = time.perf_counter()
    cfg = VocoderConfig(dropout=0.0)
    x, c = next(vt.wav_batches(wav_dir, 2, VOC_CHECK_CROP, cfg, seed=SEED))
    cpu = vt.create_wavenet(cfg, SEED + 30, "cpu").train()
    runs = {}
    for name, model in (("cpu", cpu), ("card", copy.deepcopy(cpu).to(dev))):
        d = next(model.parameters()).device
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = vt.make_wavenet_step(model, make_optimizer(model, 1e-3), ema, cfg)
        loss = step(torch.from_numpy(x).to(d), torch.from_numpy(c).to(d), 0).item()
        runs[name] = (loss, model, ema, p0)
    (l_c, m_c, _, _), (l_g, m_g, ema, p0) = runs["cpu"], runs["card"]
    loss_err = abs(l_g - l_c) / abs(l_c)
    grad_err = grads_rel_err(m_c, m_g)
    lr, dec = 1e-3, vt.ema_decay_at(0)
    upd_err = ema_err = 0.0
    for n, p in m_g.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        p = p.detach()
        want = p0[n] - lr * g / (g.abs() + 1e-8)  # Adam's first step
        upd_err = max(upd_err, (p - want).abs().max().item() / lr)
        ema_err = max(ema_err, (ema[n] - (dec * p0[n] + (1 - dec) * p)).abs().max().item()
                      / max(p.abs().max().item(), 1e-12))
    print(f"vocoder step card vs CPU [{card}] WaveNet full width, float32, batch 2 x "
          f"{VOC_CHECK_CROP} samples, dropout 0, TF32 off ({time.perf_counter() - t0:.1f} s): "
          f"NLL {l_c:.4f}, rel err {loss_err:.3e} (limit {TERM_RTOL}); gradients rel err "
          f"{grad_err:.3e} (limit {GRAD_RTOL}); Adam's first update against its formula "
          f"{upd_err:.3e} of lr (limit {UPDATE_RTOL}); EMA (d = {dec:.4f}) against "
          f"d e + (1 - d) p {ema_err:.3e} (limit {EMA_RTOL})", flush=True)
    check(loss_err <= TERM_RTOL, f"WaveNet step NLL card vs CPU {loss_err}")
    check(grad_err <= GRAD_RTOL, f"WaveNet step gradients card vs CPU {grad_err}")
    check(upd_err <= UPDATE_RTOL, f"WaveNet Adam update against its formula {upd_err}")
    check(ema_err <= EMA_RTOL, f"WaveNet EMA against its formula {ema_err}")

    # the iSTFT vocoder at its default config, on train-vocoder's crop.  Its
    # gradient is ill-conditioned in float32: the model's input is
    # log(prior + 1e-5), and where the pinv product that makes the prior
    # cancels to near 0, its rounding (~1e-7) moves that input by up to 1%.
    # So the card's code is held tightly on the same step in float64, and
    # its float32 gradient to ISTFT_F32_GRAD_RTOL
    t0 = time.perf_counter()
    mel, wav = next(ivt.mel_wav_batches(wav_dir, 2, ISTFT_CROP, seed=SEED))
    base = seeded(lambda: ISTFTVocoder(ISTFTVocoderConfig(), AudioConfig()), SEED + 31).train()
    runs = {}
    for name, d, dt in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                        ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64)):
        model = copy.deepcopy(base).to(d, dt)
        opt = ivt.ClipAdamW(model.parameters(), lr=2e-4)
        p0 = [p.detach().clone() for p in model.parameters()]
        terms = ivt.make_istft_step(model, opt)(torch.from_numpy(mel).to(d, dt),
                                                torch.from_numpy(wav).to(d, dt))
        runs[name] = ([t.item() for t in terms], model, opt, p0)
    (t_c, m_c, _, _), (t_g, m_g, opt, p0) = runs["cpu"], runs["card"]
    term_err = max(abs(a - b) / abs(a) for a, b in zip(t_c, t_g))
    grad_err = grads_rel_err(m_c, m_g)
    f64_err = grads_rel_err(runs["cpu64"][1], runs["card64"][1])
    grads = [p.grad for p in m_g.parameters()]
    norm = math.sqrt(sum((g.double() ** 2).sum().item() for g in grads))
    upd_err = 0.0
    for p, g, q0 in zip(m_g.parameters(), grads, p0):
        gc = g / max(norm, 1.0)  # clip_by_global_norm(1.0)
        m, v = 0.1 * gc, 0.001 * gc * gc
        want = q0 - 2e-4 * ((m / 0.1) / (torch.sqrt(v / 0.001) + 1e-8) + 1e-5 * q0)
        upd_err = max(upd_err, (p.detach() - want).abs().max().item() / 2e-4)
    print(f"vocoder step card vs CPU [{card}] iSTFT default config, batch 2 x {ISTFT_CROP} "
          f"frames, TF32 off ({time.perf_counter() - t0:.1f} s): loss {t_c[0]:.4f} (mrstft "
          f"{t_c[1]:.4f}, l1 {t_c[2]:.4f}), terms rel err {term_err:.3e} (limit {TERM_RTOL}); "
          f"gradients rel err {grad_err:.3e} (limit {ISTFT_F32_GRAD_RTOL}); the same step in "
          f"float64, gradients "
          f"rel err {f64_err:.3e} (limit {F64_GRAD_RTOL}); global norm {norm:.3f}; "
          f"clip + AdamW's first update against its formula {upd_err:.3e} of lr (limit "
          f"{UPDATE_RTOL})", flush=True)
    check(term_err <= TERM_RTOL, f"iSTFT step loss terms card vs CPU {term_err}")
    check(grad_err <= ISTFT_F32_GRAD_RTOL, f"iSTFT step gradients card vs CPU {grad_err}")
    check(f64_err <= F64_GRAD_RTOL, f"iSTFT float64 step gradients card vs CPU {f64_err}")
    check(upd_err <= UPDATE_RTOL, f"iSTFT clip + AdamW against its formula {upd_err}")


def held_out_losses(dev, wav_dir, paths) -> dict[str, tuple[float, float]]:
    """Phase 11 (i): each vocoder's loss, the mean over VOC_HELD_BATCHES
    fixed batches at train-vocoder's shapes (drawn from another seed than
    training's), for the weights its trainer starts from (seed 0) and for
    the checkpoint it wrote; without dropout.  arch -> (initial, trained)."""
    from dvc_tpu_torch.config import AudioConfig, ISTFTVocoderConfig, VocoderConfig
    from dvc_tpu_torch.convert.griffinlim import istft
    from dvc_tpu_torch.convert.vocode import load_istft_params, load_vocoder_params
    from dvc_tpu_torch.models.istft_vocoder import ISTFTVocoder
    from dvc_tpu_torch.models.wavenet import WaveNet, discretized_mix_logistic_loss
    from dvc_tpu_torch.train import istft_vocoder_trainer as ivt
    from dvc_tpu_torch.train import vocoder_trainer as vt

    vcfg, acfg = VocoderConfig(), AudioConfig()
    trained_wn = WaveNet(vcfg)
    trained_wn.load_state_dict(load_vocoder_params(paths["wavenet"]))
    trained_is = ISTFTVocoder(ISTFTVocoderConfig(), acfg)
    trained_is.load_state_dict(load_istft_params(paths["istft"]))

    def wavenet_nll(model, x, c):
        y_hat = model(x, c)
        return discretized_mix_logistic_loss(y_hat[:, :-1], x[:, 1:],
                                             log_scale_min=vcfg.log_scale_min)

    def istft_loss(model, mel, wav):
        pred = istft(model(mel), wav.shape[-1], acfg)
        return ivt.multi_resolution_stft_loss(pred, wav) + 0.1 * (pred - wav).abs().mean()

    out = {}
    for arch, init, trained, batches, loss in (
            ("wavenet", vt.create_wavenet(vcfg, 0, "cpu"), trained_wn,
             vt.wav_batches(wav_dir, 2, 8000, vcfg, seed=SEED + 40), wavenet_nll),
            ("istft", seeded(lambda: ISTFTVocoder(ISTFTVocoderConfig(), acfg), 0), trained_is,
             ivt.mel_wav_batches(wav_dir, 2, ISTFT_CROP, seed=SEED + 40), istft_loss)):
        held = [tuple(torch.from_numpy(a).to(dev) for a in next(batches))
                for _ in range(VOC_HELD_BATCHES)]
        means = []
        for model in (init, trained):
            model = model.to(dev).eval()
            with torch.no_grad():
                means.append(sum(loss(model, *b).item() for b in held) / len(held))
            model.cpu()
        out[arch] = tuple(means)
    return out


def logged_losses(out: str, tag: str) -> list[float]:
    """The losses a train-vocoder child printed: "<tag> <step>: <name> <x>"."""
    return [float(ln.split(": ")[1].split()[1]) for ln in out.splitlines()
            if ln.startswith(tag)]


def vocoder_phase(card, dev, recipe, mel8, run8, b_main, f_main):
    """Phase 11: the vocoders trained and served.  (i) `train-vocoder` for
    the WaveNet at the CLI defaults and with --arch istft, as children at
    once on phase 10's corpus; (ii) meanwhile one step of each on the card
    against the CPU; (iii) `serve --vocoder istft` on phase 8's checkpoint;
    (iv) `convert` with the trained WaveNet, and the sampler kernel on its
    EMA weights against the plain versions; (v) timings."""
    kids = Children(recipe)
    try:
        vocoder_steps(card, dev, recipe, mel8, run8, b_main, f_main, kids)
    finally:
        kids.kill_all()


def vocoder_steps(card, dev, recipe, mel8, run8, b_main, f_main, kids):
    from dvc_tpu_torch.cli import run as cli
    from dvc_tpu_torch.config import Config, VocoderConfig
    from dvc_tpu_torch.convert.vocode import load_vocoder_params, make_istft_vocoder
    from dvc_tpu_torch.kernels import wavenet_step as ws
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.models.wavenet import WaveNet
    from dvc_tpu_torch.serve import ConversionService, make_http_server
    from dvc_tpu_torch.train import istft_vocoder_trainer as ivt
    from dvc_tpu_torch.train import vocoder_trainer as vt
    from dvc_tpu_torch.train.checkpoint import load_last_checkpoint
    from dvc_tpu_torch.utils.wavio import parse_wav, read_wav
    wav16 = os.path.join(recipe, "vctk", "VCTK-Corpus", "wav16")
    models = os.path.join(recipe, "vocoders")

    # (i) both trainers as children at once; (ii) meanwhile, here
    kids.start("train_vocoder_wavenet", ["train-vocoder", wav16, "-m", models,
                                         "--n_steps", str(VOC_STEPS)])
    kids.start("train_vocoder_istft", ["train-vocoder", wav16, "-m", models, "--arch",
                                       "istft", "--n_steps", str(VOC_STEPS)])
    vocoder_steps_against_cpu(card, dev, wav16)
    paths = {}
    for arch, tag, name in (("wavenet", "vocoder step", "wavenet_step"),
                            ("istft", "istft-voc step", "istft_voc_step")):
        said, secs = kids.wait(f"train_vocoder_{arch}")
        paths[arch] = os.path.join(models, f"{name}{VOC_STEPS:09d}.msgpack")
        losses = logged_losses(said, tag)
        check(os.path.exists(paths[arch]), f"train-vocoder {arch} wrote no {paths[arch]}")
        check(len(losses) >= 2 and all(math.isfinite(v) for v in losses),
              f"train-vocoder {arch} losses {losses}")
        print(f"train-vocoder {arch} [{card}]: child process {secs:.1f} s for {VOC_STEPS} "
              f"steps (start to exit: corpus load and resampling included, the other child "
              f"beside it); logged losses {[round(v, 4) for v in losses]}; wrote "
              f"{os.path.basename(paths[arch])}", flush=True)
    for arch, (first, last) in held_out_losses(dev, wav16, paths).items():
        print(f"train-vocoder {arch} [{card}]: loss over {VOC_HELD_BATCHES} held batches, "
              f"mean: the initial weights {first:.4f}, the checkpoint {last:.4f}", flush=True)
        check(math.isfinite(last) and last < first,
              f"train-vocoder {arch}: the checkpoint's held loss {last} is not below the "
              f"initial weights' {first}")

    # (iii) serve --vocoder istft on phase 8's checkpoint: 3 concurrent requests
    port = free_port()
    t0 = time.perf_counter()
    proc = start_serve(["--dataset_fp", mel8, "--log_dir", run8, "--vocoder", "istft",
                        "--vocoder_ckpt", paths["istft"], "--max_wait_ms", "500"], port,
                       dev.type, os.path.join(recipe, f"serve_{port}.log"))
    up_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{port}"
    bodies = [request_body(16000, i) for i in (1, 2, 3)]
    try:
        post_convert(url, request_body(16000, 99))  # warm-up
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            before = json.loads(r.read())
        with ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(lambda b: post_convert(url, b), bodies))
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            after = json.loads(r.read())
    finally:
        stop(proc)
    served = []
    for status, data, _ in replies:
        wav, sr = parse_wav(data)
        check(status == 200 and sr == 16000 and wav.shape == (BENCH_FRAMES * 256,)
              and np.isfinite(wav).all() and wav.std() > 1e-3,
              f"serve --vocoder istft: reply {status}, {sr} Hz, {wav.shape}")
        served.append(wav)
    d_req, d_bat = (after[k] - before[k] for k in ("requests", "batches"))
    check(d_req == 3 and d_bat == 1, f"serve --vocoder istft: {d_req} requests in {d_bat} drains")
    lat = sorted(r[2] for r in replies)
    print(f"serve --vocoder istft [{card}]: up in {up_s:.1f} s; 3 concurrent POST /convert of "
          f"0.5 s answered 200 with {BENCH_FRAMES * 256}-sample wavs in {d_bat} drain; latency "
          f"min {lat[0]:.3f} s, max {lat[-1]:.3f} s", flush=True)

    # the same requests' mels, from the same VAE served here without a
    # vocoder, synthesized on the card and on the CPU
    vae = DisentangledVAE(Config().vae)
    load_last_checkpoint(os.path.join(run8, "checkpoints"), vae)
    service = ConversionService(Config(), vae, mel8, vocoder=None, max_wait_ms=500.0,
                                device=dev)
    port = free_port()
    server = make_http_server(service, "127.0.0.1", port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with ThreadPoolExecutor(3) as pool:
            mel_replies = list(pool.map(lambda b: post_convert(f"http://127.0.0.1:{port}", b),
                                        bodies))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    mels = [np.load(io.BytesIO(r[1])) for r in mel_replies]
    voc_card = make_istft_vocoder(paths["istft"], device=dev)
    voc_cpu = make_istft_vocoder(paths["istft"], device="cpu")
    want = voc_cpu.batch(mels)
    voc_card.batch(mels)  # warm-up: cuDNN and cuFFT plans
    got, syn_ms = events_ms(lambda: voc_card.batch(mels))
    peak = max(np.abs(w).max() for w in want)
    syn_err = max(np.abs(g - w).max() for g, w in zip(got, want)) / peak
    # the last samples of a bucket-long mel's synthesis lie at the
    # overlap-add's edge, amplified (dvc_tpu's behaviour, ROADMAP Queue 3):
    # their peak over the rest's, in the served wavs
    spike = [np.abs(w[-32:]).max() / np.abs(w[:-256]).max() for w in served]
    audio_s = sum(len(w) for w in got) / 16000
    print(f"iSTFT synthesis [{card}] of the 3 requests' mels {[m.shape for m in mels]} in one "
          f"batch: card {syn_ms:.2f} ms ({audio_s / (syn_ms / 1e3):.1f}x real time for "
          f"{audio_s:.3f} s of audio), card against CPU {syn_err:.3e} of the peak (limit "
          f"{ISTFT_PEAK_RTOL}); the served wavs' last 32 samples peak at "
          f"{', '.join(f'{v:.1f}' for v in spike)}x the rest's (reported)",
          flush=True)
    check(syn_err <= ISTFT_PEAK_RTOL, f"iSTFT synthesis card vs CPU {syn_err}")

    # (iv) convert with the trained WaveNet: one launch of the sampler
    mels10, run10 = os.path.join(recipe, "mels_no_trim"), os.path.join(recipe, "run")
    ws.wavenet_generate.launches.clear()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        check(cli.main(["convert", "--dataset_fp", mels10, "--log_dir", run10, "--src_spk",
                        "p228", "--trg_spk", "p227", "--num_utterances", "1",
                        "--vocoder_ckpt", paths["wavenet"], "--device", "cuda"]) == 0,
              "convert with the trained WaveNet")
        torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    launches = dict(ws.wavenet_generate.launches)
    recs = sum(e.count for e in prof.key_averages() if "wavenet_persistent" in e.key)
    out = os.path.join(run10, "generation", "p228_to_p227", "convert_p228_to_p227_000.wav")
    w, sr = read_wav(out)
    check(recs == 1 and launches == {"bfloat16": 1},
          f"trained WaveNet convert: {recs} wavenet_persistent records, launches {launches}")
    check(sr == 16000 and np.isfinite(w).all() and np.abs(w).max() <= 1.0 and w.std() > 0,
          f"trained WaveNet convert wrote {out}")
    print(f"convert with the trained WaveNet [{card}]: {conv_s:.1f} s in this process for 1 "
          f"utterance ({len(w) / 16000:.2f} s of audio): {recs} wavenet_persistent record, "
          f"launches {launches}", flush=True)

    # the kernel on the trained EMA weights: float32 with feedback (the fine
    # check), then bf16 at the main path's shape with the feedback cut
    trained = WaveNet(VocoderConfig())
    trained.load_state_dict(load_vocoder_params(paths["wavenet"]))
    trained = trained.to(dev).eval()
    nofb = copy.deepcopy(trained)
    with torch.no_grad():
        nofb.first_conv.weight.zero_()
    g = torch.Generator(device=dev).manual_seed(60)
    frames = torch.rand(b_main, f_main, 80, device=dev, generator=g)
    with torch.inference_mode():
        cond = trained.upsample(frames).contiguous()
    f32 = ws.pack_wavenet_params(trained, torch.float32, dev)
    cond_s = cond[:, :1024].contiguous()
    plain = ws.wavenet_generate_plain(f32, cond_s, 0, True)
    err = (ws.wavenet_generate(f32, cond_s, 0, True) - plain).abs().max().item()
    bad = (ws.wavenet_generate(layer0_wrong_tap(f32), cond_s, 0, True) - plain).abs().max().item()
    print(f"kernel on the trained EMA weights [{card}] float32 with feedback, cond "
          f"{tuple(cond_s.shape)}: max_abs_err {err:.3e} (atol {F32_ATOL}); trajectory std "
          f"{plain.std().item():.4f}; layer 0's ring taps at twice its dilation: "
          f"{bad:.3e}, {'caught' if bad > F32_ATOL else 'NOT caught'} (reported)", flush=True)
    check(math.isfinite(err) and err <= F32_ATOL, f"trained weights, float32: kernel vs plain {err}")

    pk = ws.pack_wavenet_params(nofb, torch.bfloat16, dev)
    ref = ws.wavenet_open_loop_plain(pk, cond)
    kern, draws, _ = ws.wavenet_generate_checked(pk, cond, 0, True)
    check(bool((draws == kern[None]).all()), "trained weights: the blocks' draws disagree")

    def errs(out):
        d = out - ref
        return d.abs().max().item(), d.pow(2).mean().sqrt().item()

    def passes(e, atol, rms):
        return math.isfinite(e[0]) and e[0] <= atol and e[1] <= rms

    e_ok = errs(kern)
    e_bad = errs(ws.wavenet_generate(layer0_wrong_tap(pk), cond, 0, True))
    caught = not passes(e_bad, TRAINED_NOFB_ATOL, TRAINED_NOFB_RMS)
    caught6 = not passes(e_bad, MAIN_NOFB_ATOL, MAIN_NOFB_RMS)
    print(f"kernel on the trained EMA weights [{card}] bf16, cond {tuple(cond.shape)}, no "
          f"feedback, against the open-loop plain version: max_abs_err {e_ok[0]:.3e}, rms err "
          f"{e_ok[1]:.3e} (atol {TRAINED_NOFB_ATOL}, rms {TRAINED_NOFB_RMS}; phase 6 (v)'s "
          f"{MAIN_NOFB_ATOL}, {MAIN_NOFB_RMS}: "
          f"{'met' if passes(e_ok, MAIN_NOFB_ATOL, MAIN_NOFB_RMS) else 'NOT met'}); trajectory "
          f"std {ref.std().item():.4f}; layer 0's ring taps at twice its dilation: max "
          f"{e_bad[0]:.3e}, rms {e_bad[1]:.3e}, {'caught' if caught else 'NOT caught'} "
          f"({'caught' if caught6 else 'NOT caught'} at phase 6 (v)'s limits; reported)",
          flush=True)
    check(passes(e_ok, TRAINED_NOFB_ATOL, TRAINED_NOFB_RMS),
          f"trained weights, no feedback: kernel vs plain {e_ok}")

    # (v) ms a train step and peak memory, each arch at its CLI shapes, alone
    del trained, nofb, pk, f32
    torch.cuda.empty_cache()
    vcfg = VocoderConfig()
    x, c = (torch.from_numpy(a).to(dev)
            for a in next(vt.wav_batches(wav16, 2, 8000, vcfg, seed=SEED)))
    mel, wav = (torch.from_numpy(a).to(dev)
                for a in next(ivt.mel_wav_batches(wav16, 2, ISTFT_CROP, seed=SEED)))
    for name, trainer, step, iters in (
            ("WaveNet (24 layers, 512 channels), batch 2 x 7936 samples",
             vt.VocoderTrainer(vcfg, device=dev), lambda tr: tr.step_on(x, c), 10),
            ("iSTFT (512 channels, 8 blocks), batch 2 x 31 frames",
             ivt.ISTFTVocoderTrainer(device=dev), lambda tr: tr.step_fn(mel, wav), 20)):
        for _ in range(3):
            step(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held_gb = torch.cuda.memory_allocated(dev) / 1e9
        _, ms = events_ms(lambda: [step(trainer) for _ in range(iters)])
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        extra = ""
        if name.startswith("WaveNet"):
            tflop = 3 * 2 * WAVENET_MACS * x.shape[0] * x.shape[1] / 1e12
            extra = (f"; ~{tflop:.2f} TFLOP a step (forward and backward), "
                     f"{tflop / (ms / iters / 1e3):.1f} TFLOP/s, float32 bound "
                     f"{tflop * 1e12 / PEAK_FLOPS[torch.float32] * 1e3:.1f} ms")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, p_ms = events_ms(lambda: [step(trainer) for _ in range(3)])
        busy_us = device_busy_us(prof)
        extra += (f"; the profiler over 3 steps: device busy {busy_us / 1e3:.1f} of {p_ms:.1f} "
                  f"ms (idle share {1 - busy_us / (p_ms * 1e3):.3f})" if busy_us > 0
                  else "; device busy not measured (no device time recorded)")
        print(f"vocoder train step [{card}] {name}: {ms / iters:.2f} ms a step (mean of "
              f"{iters}), peak memory {peak_gb:.2f} GB ({peak_gb - held_gb:.2f} GB above the "
              f"{held_gb:.2f} GB allocated before){extra}", flush=True)
        del trainer
        torch.cuda.empty_cache()


ADV_SPEAKERS = len(RECIPE_SPEAKERS)  # phase 12: the adversary's width on phase 10's corpus
FS_LATENTS = 64         # phase 12 (i): the FS step's batch, FeatureSelectionTrainer's
RESOLVED_G = 1e-6       # phase 12 (i): 100 x Adam's eps; where |g| is above it Adam's first
                        # step is within 1% of +-lr, so the updated FS weights are held to
                        # 1e-5 there and every step to 2 lr (tests/test_torch_port_
                        # feature_selection.py's rule)
FS_ATOL = 1e-5          # the FS step's loss (relative) and updated weights
REMAT_GRAD_RTOL = 1e-5  # phase 12 (i): the remat step against the plain step on the card,
                        # each gradient of its max: the same arithmetic, recomputed
F32_VAE_GRAD_RTOL = 0.1  # phase 12 (i): the adversarial step's VAE gradients in float32
                        # card against CPU, of each one's max.  The float32 pair step's
                        # gradients are ill-conditioned on some batches (the encoder's and
                        # decoder's convolutions ahead of a train-mode BatchNorm): the plain
                        # step on the CPU in float32 against float64 reads 1.1e-5 to 1.6e-2
                        # over three batches, the card 3.1e-2 on this one, where the card in
                        # float64 agrees with the CPU to 4e-6 (PERF.md section 6).  So the
                        # step is held at GRAD_RTOL in float64, and at this in float32


def latent_steps_against_cpu(card, dev, mels, run):
    """Phase 12 (i): at the full VAEConfig, batch 8: one adversarial step in
    each mode on the card against the CPU, in float32 and in float64; the
    remat step against the plain step on the card, in float64; one FS step
    on the card against the CPU; and convert_mel_long_context on phase 10's
    checkpoint card against CPU."""
    from dvc_tpu_torch.config import VAEConfig
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.models.feature_selection import FeatureSelection
    from dvc_tpu_torch.models.long_context import convert_mel_long_context
    from dvc_tpu_torch.train.adversarial import SpeakerAdversary, make_adv_train_step
    from dvc_tpu_torch.train.checkpoint import load_last_checkpoint
    from dvc_tpu_torch.train.feature_selection_trainer import make_fs_step
    from dvc_tpu_torch.train.trainer import make_optimizer, make_train_step
    t0 = time.perf_counter()
    v = VAEConfig()
    rng = np.random.RandomState(12)
    x1, x2 = (torch.from_numpy(rng.rand(TRAIN_BATCH, v.num_mels, v.frames).astype(np.float32))
              for _ in range(2))
    eps = [torch.from_numpy(rng.randn(TRAIN_BATCH, n).astype(np.float32))
           for n in (v.content_size, v.content_size, v.speaker_size)]
    spk = torch.from_numpy(rng.randint(0, ADV_SPEAKERS, TRAIN_BATCH))
    base = seeded(lambda: DisentangledVAE(v, pair_fused=True), SEED + 6).train()
    adv0 = SpeakerAdversary(v.content_size, ADV_SPEAKERS,
                            generator=torch.Generator().manual_seed(SEED + 2))
    for mode in ("confusion", "grl"):
        for dt, vae_limit in ((torch.float32, F32_VAE_GRAD_RTOL), (torch.float64, GRAD_RTOL)):
            out = {}
            for name, d in (("cpu", "cpu"), ("card", dev)):
                model, adv = copy.deepcopy(base).to(d, dt), copy.deepcopy(adv0).to(d, dt)
                step = make_adv_train_step(model, make_optimizer(model, 1e-4), adv,
                                           make_optimizer(adv, 1e-3), adv_cof=1.0, mode=mode,
                                           compute_dtype="float32")
                terms, m = step(x1.to(d, dt), x2.to(d, dt), spk.to(d),
                                eps=tuple(e.to(d, dt) for e in eps))
                out[name] = ([t.item() for t in terms] + [m["adv_ce"].item()],
                             m["adv_acc"].item(),
                             {n: p.grad.cpu() for n, p in model.named_parameters()},
                             {n: p.grad.cpu() for n, p in adv.named_parameters()})
            (t_c, a_c, g_c, ag_c), (t_g, a_g, g_g, ag_g) = out["cpu"], out["card"]
            term_err = max(abs(a - b) / max(abs(a), 1e-12) for a, b in zip(t_c, t_g))
            grad_err, bias_share = vae_grad_errs(g_c, g_g)
            adv_err = max((ag_c[n] - ag_g[n]).abs().max().item() / ag_c[n].abs().max().item()
                          for n in ag_c)
            tag = f"{mode} {str(dt).replace('torch.', '')}"
            print(f"adv step card vs CPU [{card}] {tag}, full width, batch {TRAIN_BATCH}, "
                  f"adv_cof 1: adv_ce {t_c[-1]:.4f}, adv_acc {a_c:.3f} (card {a_g:.3f}); loss "
                  f"terms and adv_ce rel err {term_err:.3e} (limit {TERM_RTOL}); VAE gradients "
                  f"rel err {grad_err:.3e} (limit {vae_limit}), adversary gradients "
                  f"{adv_err:.3e} (limit {GRAD_RTOL}); pre-BN conv biases' share "
                  f"{bias_share:.3e} (limit {PRE_BN_BIAS_SHARE})", flush=True)
            check(term_err <= TERM_RTOL, f"adv step {tag}: loss terms card vs CPU {term_err}")
            check(a_c == a_g, f"adv step {tag}: adv_acc card {a_g} vs CPU {a_c}")
            check(grad_err <= vae_limit and adv_err <= GRAD_RTOL,
                  f"adv step {tag}: gradients card vs CPU {grad_err}, {adv_err}")
            check(bias_share <= PRE_BN_BIAS_SHARE, f"adv step {tag}: pre-BN biases {bias_share}")

    # remat against the plain step, both on the card, in float64 (where the
    # gradients are well conditioned: see F32_VAE_GRAD_RTOL)
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base).to(dev, torch.float64)
        terms = make_train_step(model, make_optimizer(model, 1e-4), compute_dtype="float32",
                                remat=remat)(x1.to(dev, torch.float64), x2.to(dev, torch.float64),
                                             eps=tuple(e.to(dev, torch.float64) for e in eps))
        runs.append(([t.item() for t in terms],
                     {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {n: b.cpu() for n, b in model.named_buffers()}))
    (t_p, g_p, b_p), (t_r, g_r, b_r) = runs
    term_err = max(abs(a - b) / max(abs(a), 1e-12) for a, b in zip(t_p, t_r))
    grad_err, _ = vae_grad_errs(g_p, g_r)
    stats_equal = all(torch.equal(b_p[n], b_r[n]) for n in b_p)
    counted = sorted({b.item() for n, b in b_r.items() if "num_batches_tracked" in n})
    stat_diff = max((b_p[n].double() - b_r[n].double()).abs().max().item() for n in b_p)
    print(f"remat step vs plain step [{card}] full width, float64, batch {TRAIN_BATCH}: loss "
          f"terms rel err {term_err:.3e}, gradients rel err {grad_err:.3e} (limit "
          f"{REMAT_GRAD_RTOL}); BN running stats equal to the plain step's: {stats_equal} "
          f"(max diff {stat_diff:.3e}); batches counted {counted}", flush=True)
    check(grad_err <= REMAT_GRAD_RTOL and term_err <= REMAT_GRAD_RTOL,
          f"remat step gradients against the plain step {grad_err}, terms {term_err}")
    check(stats_equal and counted == [1], f"remat step BN statistics: equal {stats_equal}, "
          f"batches counted {counted}")

    # one FS step on latents of the full latent width
    fs0 = FeatureSelection(v.latent_dim, ADV_SPEAKERS, torch.Generator().manual_seed(0))
    lat = torch.from_numpy(rng.randn(FS_LATENTS, v.latent_dim).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, ADV_SPEAKERS, FS_LATENTS))
    out = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        fs = copy.deepcopy(fs0).to(d)
        loss, acc = make_fs_step(fs, torch.optim.Adam(fs.parameters(), lr=1e-3))(
            lat.to(d), lab.to(d))
        out[name] = (loss.item(), acc.item(), {n: (p.detach().cpu(), p.grad.cpu())
                                               for n, p in fs.named_parameters()})
    (l_c, acc_c, p_c), (l_g, acc_g, p_g) = out["cpu"], out["card"]
    w_err, w_step = 0.0, 0.0
    for n, (pc, gc) in p_c.items():
        sure = gc.abs() > RESOLVED_G
        d = (p_g[n][0] - pc).abs()
        w_err = max(w_err, d[sure].max().item() if sure.any() else 0.0)
        w_step = max(w_step, d.max().item())
    fs_err = abs(l_g - l_c) / abs(l_c)
    print(f"FS step card vs CPU [{card}] latent {v.latent_dim}, {ADV_SPEAKERS} speakers, "
          f"batch {FS_LATENTS}: loss {l_c:.5f}, rel err {fs_err:.3e}, acc {acc_c:.3f} (card "
          f"{acc_g:.3f}); updated weights max err {w_err:.3e} where |g| > {RESOLVED_G} "
          f"(limit {FS_ATOL}), {w_step:.3e} anywhere (limit 2 lr)", flush=True)
    check(fs_err <= FS_ATOL and acc_c == acc_g, f"FS step loss {fs_err}, acc {acc_c} {acc_g}")
    check(w_err <= FS_ATOL and w_step <= 2e-3, f"FS step weights {w_err}, {w_step}")

    # convert_mel_long_context with phase 10's trained VAE on a phase 10 utterance
    src = np.load(os.path.join(mels, "p225", sorted(
        f for f in os.listdir(os.path.join(mels, "p225")) if f.endswith(".npy"))[0]))
    trg = np.load(os.path.join(mels, "p226", sorted(
        f for f in os.listdir(os.path.join(mels, "p226")) if f.endswith(".npy"))[0]))
    res = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        model = DisentangledVAE(v)
        load_last_checkpoint(os.path.join(run, "checkpoints"), model)
        res[name] = convert_mel_long_context(model.to(d).eval(), src, trg, v.frames)
    lc_err = max(float(np.abs(a - b).max()) for a, b in zip(res["cpu"], res["card"]))
    print(f"long-context conversion card vs CPU [{card}] phase 10's checkpoint, source "
          f"{src.shape[1]} frames -> {res['card'][1].shape[1]} ({-(-src.shape[1] // v.frames)} "
          f"chunks), target {trg.shape[1]} frames: mels max abs err {lc_err:.3e} (limit "
          f"{MEL_CARD_ATOL}) ({time.perf_counter() - t0:.1f} s for (i))", flush=True)
    check(all(np.isfinite(a).all() for a in res["card"]), "long-context mels not finite")
    check(lc_err <= MEL_CARD_ATOL, f"long-context conversion card vs CPU {lc_err}")


def latent_step_timings(card, dev, plain8):
    """Phase 12 (ii): ms a step and peak memory at bench.py's batch of the
    plain, the adversarial (confusion) and the remat step, in turns after
    warm-up, beside phase 8's plain step."""
    from dvc_tpu_torch.config import Config, LossConfig, TrainConfig
    from dvc_tpu_torch.train.trainer import Trainer
    g = torch.Generator(device=dev).manual_seed(3)
    xb1, xb2 = (torch.rand(BENCH_BATCH, 80, BENCH_FRAMES, device=dev, generator=g)
                for _ in range(2))
    spk = torch.randint(0, ADV_SPEAKERS, (BENCH_BATCH,), device=dev, generator=g)
    train = TrainConfig(batch_size=BENCH_BATCH, seed=SEED)
    iters, read = 20, {}
    for name, cfg in (
            ("plain", Config(train=train)),
            ("adv (confusion)", Config(train=train, loss=LossConfig(
                adv_cof=1.0, adv_speakers=ADV_SPEAKERS))),
            ("remat", Config(train=dataclasses.replace(train, remat=True)))):
        tr = Trainer(cfg, device=dev)
        for _ in range(3):
            tr.step_on(xb1, xb2, spk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held_gb = torch.cuda.memory_allocated(dev) / 1e9
        _, ms = events_ms(lambda: [tr.step_on(xb1, xb2, spk) for _ in range(iters)])
        loss = tr.step_on(xb1, xb2, spk).total.item()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        check(math.isfinite(loss), f"{name} bench step loss not finite")
        read[name] = (ms / iters, peak_gb, held_gb)
        del tr
        torch.cuda.empty_cache()
    base_ms = read["plain"][0]
    for name, (ms, peak, held) in read.items():
        print(f"train step [{card}] {name}, batch {BENCH_BATCH} x {BENCH_FRAMES} frames, "
              f"bfloat16 inputs, float32 compute (TF32 off), pair_fused: {ms:.2f} ms a step "
              f"(mean of {iters}; {ms / base_ms:.3f}x this phase's plain step), "
              f"{2 * BENCH_BATCH * BENCH_FRAMES / (ms / 1e3):.1f} mel frames/s, peak memory "
              f"{peak:.2f} GB ({peak - held:.2f} GB above the {held:.2f} GB held)", flush=True)
    print(f"train step [{card}] phase 8's plain step in this run: {plain8['ms']:.2f} ms, peak "
          f"{plain8['peak_gb']:.2f} GB ({plain8['peak_gb'] - plain8['held_gb']:.2f} GB above "
          "what was held)", flush=True)


def has_matplotlib() -> tuple[bool, str]:
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        return False, f"{type(e).__name__}: {e}"
    return True, ""


def latent_phase(card, dev, recipe, plain8):
    """Phase 12: the mel VAE's remaining train and convert options.  (i)
    card against CPU; (ii) step timings; (iii) `train --adv_cof 1` and
    `train-fs` as children at once, then `convert --fs_mask ... --analyze`
    and `convert --long_context --analyze` at once."""
    kids = Children(recipe)
    try:
        latent_steps(card, dev, recipe, plain8, kids)
    finally:
        kids.kill_all()


def latent_steps(card, dev, recipe, plain8, kids):
    from dvc_tpu_torch.utils.wavio import read_wav
    mels, run = os.path.join(recipe, "mels_no_trim"), os.path.join(recipe, "run")
    run_adv = os.path.join(recipe, "run_adv")
    pngs, why = has_matplotlib()
    kids.start("train_adv", ["train", "--dataset_fp", mels, "--log_dir", run_adv,
                             "--epochs", "2", "--batch-size", str(TRAIN_BATCH),
                             "--samples_length", "64", "--report-interval", "2",
                             "--seed", str(SEED), "--adv_cof", "1"])
    kids.start("train_fs", ["train-fs", "--dataset_fp", mels, "--log_dir", run,
                            "--fs_epochs", "10"])
    latent_steps_against_cpu(card, dev, mels, run)

    said, secs = kids.wait("train_adv")
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in said.splitlines()
              if "Epoch" in ln]
    have = sorted(os.listdir(os.path.join(run_adv, "checkpoints")))
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
          f"train --adv_cof: losses {losses}: {said[-1500:]}")
    check(have == [f"DisentangledVAE_VCTK_2{s}" for s in (".msgpack", ".opt.pth", ".pth")],
          f"train --adv_cof wrote {have}")
    tb = os.path.join(run_adv, "logs", "DisentangledVAE_VCTK")
    events = b"".join(open(os.path.join(tb, f), "rb").read() for f in os.listdir(tb)) \
        if os.path.isdir(tb) else b""
    check(b"Loss\\Adversary CE" in events and b"Loss\\Adversary Acc" in events,
          "train --adv_cof: no Adversary CE / Acc scalars in its TensorBoard log")
    est = os.path.join(run_adv, "images", "estimation")
    est_pngs = sorted(os.listdir(est)) if os.path.isdir(est) else []
    if pngs:
        check(len(est_pngs) == 10, f"train --adv_cof estimation PNGs: {est_pngs}")
    print(f"train --adv_cof 1 [{card}]: child process {secs:.1f} s (start to exit, train-fs "
          f"beside it), epoch losses {losses}; {', '.join(have)}; Adversary CE and Acc in "
          f"its TensorBoard log; {len(est_pngs)} estimation PNGs", flush=True)
    said, secs = kids.wait("train_fs")
    fm = np.load(os.path.join(run, "feature_mask.npz"))
    check(fm["mask"].shape == (32,) and np.isfinite(fm["mask"]).all()
          and 0 <= float(fm["acc"]) <= 1, f"feature_mask.npz {fm['mask']} {fm['acc']}")
    fs_said = [ln for ln in said.splitlines() if ln.startswith(("fs epoch 9", "speaker-"))]
    print(f"train-fs [{card}]: child process {secs:.1f} s (start to exit); {fs_said}; "
          f"feature_mask.npz acc {float(fm['acc']):.3f}", flush=True)

    # (iii) the two converts at once, each with its analysis
    jobs = {"convert_fs": (run, ("p226", "p227"), ["--fs_mask",
                                                   os.path.join(run, "feature_mask.npz")]),
            "convert_lc": (run_adv, ("p227", "p228"), ["--long_context"])}
    for name, (log_dir, (src, trg), flags) in jobs.items():
        kids.start(name, ["convert", "--dataset_fp", mels, "--log_dir", log_dir, "--src_spk",
                          src, "--trg_spk", trg, "--num_utterances", "2", *flags, "--analyze"])
    for name, (log_dir, (src, trg), flags) in jobs.items():
        said, secs = kids.wait(name)
        gen = os.path.join(log_dir, "generation")
        pair_dir = os.path.join(gen, f"{src}_to_{trg}")
        files = sorted(os.listdir(pair_dir))
        wavs = [f for f in files if f.endswith(".wav")]
        check(len(wavs) == 2, f"{name} wrote {files}")
        for f in wavs:
            w, sr = read_wav(os.path.join(pair_dir, f))
            check(sr == 16000 and np.isfinite(w).all() and w.std() > 1e-3, f"{name}: {f}")
        la = np.load(os.path.join(gen, "latent_analysis.npz"))
        check(la["mus"].shape == la["stds"].shape == (ADV_SPEAKERS, 32)
              and np.isfinite(la["mus"]).all() and np.isfinite(la["stds"]).all()
              and list(la["speakers"]) == list(RECIPE_SPEAKERS),
              f"{name} latent_analysis.npz {la['mus'].shape} {list(la['speakers'])}")
        want = ["latent_analysis.npz"]
        if "--fs_mask" in flags:
            fsm = np.load(os.path.join(gen, "fs_mask.npz"))
            check(fsm["binary_mask"][:4].all() and fsm["sigmoid_mask"].shape == (32,),
                  f"{name} fs_mask.npz")
            want.append("fs_mask.npz")
        png = [f for f in files if f.endswith(".png")]
        if pngs:
            want += ["latent_analysis.png"] + (["fs_mask.png"] if "--fs_mask" in flags else [])
            check(len(png) == 8, f"{name}: {len(png)} mel PNGs, 4 an utterance expected")
        missing = [f for f in want if not os.path.exists(os.path.join(gen, f))]
        check(not missing, f"{name} did not write {missing}")
        print(f"{name} [{card}]: `convert {' '.join(flags[:1])} --analyze` child process "
              f"{secs:.1f} s (the other convert beside it): {len(wavs)} Griffin-Lim wavs, "
              f"{len(png)} mel PNGs, {', '.join(want)}", flush=True)
    if not pngs:
        print(f"PNGs [{card}]: skipped, matplotlib does not import on this host ({why})",
              flush=True)

    # (ii) alone on the card, after the children
    latent_step_timings(card, dev, plain8)


GE2E_SPEAKERS = 64      # phase 13 (iii): the synthetic GE2E corpus, one batch of speakers
GE2E_TRAIN_UTTS, GE2E_HELD_UTTS = 12, 4  # mels a speaker for train-speaker, for eval-eer
GE2E_STEPS = 300        # train-speaker's steps in the child ("a few hundred")
AUTOVC_BATCH, AUTOVC_FRAMES = 8, 64  # train-autovc's default batch and crop
SIM_RTOL = 1e-5         # phase 13 (i): the GE2E similarity matrix card against CPU, of
                        # its max (tests/test_torch_port_ge2e.py's limit against dvc_tpu)
SIM_GRAD_ATOL = 1e-8    # the two similarity gradients after the 0.01 scaling, held
                        # absolutely: means of terms of size up to 1 that cancel (the
                        # bias's exactly), tests/test_torch_port_ge2e.py's limit
F32_STEP_GRAD_RTOL = 0.1  # the GE2E and AutoVC steps' float32 gradients card against
                        # CPU, of each one's max: phase 12's float32 limit.  Float32
                        # gradients through train-mode BatchNorms and long LSTM chains
                        # can be ill-conditioned (phase 12), so float64 is the gate at
                        # GRAD_RTOL and float32 is held to this and reported
EMBED_CARD_ATOL = 1e-4  # embed_utterance card against CPU, of the unit-norm embedding


def ge2e_profiles(n, rng):
    """n distinct 3-bump spectral profiles (tools/quality_ge2e.py's): bump
    centre triples drawn without replacement from a 16-point grid, so any
    two speakers differ in at least one formant position."""
    from itertools import combinations
    grid = np.linspace(6, 74, 16)
    triples = list(combinations(range(16), 3))
    rng.shuffle(triples)
    bins = np.arange(80)
    profs = []
    for t3 in triples[:n]:
        prof = sum((0.5 + 0.5 * rng.rand()) * np.exp(-0.5 * ((bins - grid[g]) / 5.0) ** 2)
                   for g in t3)
        profs.append(prof / prof.max())
    return profs


def ge2e_utterance(prof, rng, t):
    """One (80, t) mel of a speaker: its profile under a random smooth
    content envelope, plus noise, in [0, 1] (tools/quality_ge2e.py's)."""
    tt = np.linspace(0, 1, t)
    content = sum(rng.randn() * np.sin(2 * np.pi * k * tt + rng.rand() * 6) for k in range(1, 5))
    content = 0.5 + 0.2 * content / max(1.0, np.abs(content).max())
    mel = prof[:, None] * content[None, :] + 0.08 * rng.rand(80, t)
    return np.clip(mel, 0.0, 1.0).astype(np.float32)


def ge2e_corpus(root) -> tuple[str, str]:
    """GE2E_SPEAKERS speakers, GE2E_TRAIN_UTTS mels (80, 70-200) each under
    root/train and GE2E_HELD_UTTS under root/held."""
    rng = np.random.RandomState(SEED + 50)
    dirs = (os.path.join(root, "train"), os.path.join(root, "held"))
    for si, prof in enumerate(ge2e_profiles(GE2E_SPEAKERS, rng)):
        for d, n in zip(dirs, (GE2E_TRAIN_UTTS, GE2E_HELD_UTTS)):
            os.makedirs(os.path.join(d, f"s{si:02d}"))
            for u in range(n):
                np.save(os.path.join(d, f"s{si:02d}", f"u{u:02d}.npy"),
                        ge2e_utterance(prof, rng, int(rng.randint(70, 201))))
    return dirs


def lstm_macs(lstm) -> int:
    """Multiply-adds a frame of an nn.LSTM: 4H(I + H) for each layer and
    direction (the gates' two matmuls; the elementwise work is not counted)."""
    h, dirs = lstm.hidden_size, 2 if lstm.bidirectional else 1
    return sum(4 * h * ((lstm.input_size if layer == 0 else h * dirs) + h) * dirs
               for layer in range(lstm.num_layers))


def frame_macs(module) -> int:
    """Multiply-adds a frame of every nn.LSTM, nn.Conv1d and nn.Linear below
    module, each applied once a frame."""
    total = 0
    for m in module.modules():
        if isinstance(m, torch.nn.LSTM):
            total += lstm_macs(m)
        elif isinstance(m, torch.nn.Conv1d):
            total += m.in_channels * m.out_channels * m.kernel_size[0]
        elif isinstance(m, torch.nn.Linear):
            total += m.in_features * m.out_features
    return total


def step_flops(model, kind, batch) -> float:
    """Operations of one train step, forward and backward (3 x the forward's
    2 x multiply-adds): the GE2E encoder's LSTM over every frame and its
    Linear once a sequence; AutoVC's generator over every frame plus the
    content encoder again for the re-encode."""
    if kind == "ge2e":
        s, u, t, _ = batch.shape
        fwd = lstm_macs(model.lstm) * s * u * t + frame_macs(model.linear) * s * u
    else:
        b, t, _ = batch.shape
        fwd = (frame_macs(model) + frame_macs(model.encoder)) * b * t
    return 3 * 2 * fwd


def ge2e_grad_errs(g_c, g_g) -> tuple[float, float]:
    """(worst max |diff| over max |g| of the encoder's gradients but the
    similarity pair; the worst absolute diff of the similarity pair, and
    of the bias's gradient from 0)."""
    rel, sim = 0.0, 0.0
    for n, a in g_c.items():
        b = g_g[n]
        if n.startswith("similarity"):
            sim = max(sim, (a - b).abs().max().item())
            if n == "similarity_bias":
                sim = max(sim, a.abs().max().item(), b.abs().max().item())
            continue
        rel = max(rel, (a - b).abs().max().item() / a.abs().max().item())
    return rel, sim


def speaker_steps_against_cpu(card, dev, wav_path):
    """Phase 13 (i): one GE2E step at (64, 10, 63, 80) and one AutoVC step at
    8 x 64 on the card against the CPU, float32 and float64, from the same
    weights and batch (TF32 off); the card's first GE2E update against
    Adam's formula; AutoVC's gradient without the path through the running
    statistics, reported; embed_utterance of one of phase 10's wavs."""
    from dvc_tpu_torch.config import AutoVCConfig, SpeakerEncoderConfig
    from dvc_tpu_torch.models.autovc import AutoVC
    from dvc_tpu_torch.models.layers import BatchNorm
    from dvc_tpu_torch.models.speaker_inference import SpeakerEmbedder
    from dvc_tpu_torch.train import autovc_trainer as at
    from dvc_tpu_torch.train import speaker_trainer as st
    from dvc_tpu_torch.train.trainer import make_optimizer
    from dvc_tpu_torch.utils.wavio import read_wav
    t0 = time.perf_counter()
    cfg = SpeakerEncoderConfig()
    rng = np.random.RandomState(13)
    batch = torch.from_numpy(rng.rand(cfg.speakers_per_batch, cfg.utterances_per_speaker,
                                      cfg.partials_n_frames, cfg.mel_n_channels)
                             .astype(np.float32))
    base = st.create_speaker_encoder(cfg, SEED + 40, "cpu")
    runs = {}
    for name, d, dt in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                        ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64)):
        model = copy.deepcopy(base).to(d, dt)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss, sim = st.make_ge2e_step(model, make_optimizer(model, cfg.learning_rate))(
            batch.to(d, dt))
        runs[name] = (loss.item(), sim.cpu().double(),
                      {n: p.grad.cpu().double() for n, p in model.named_parameters()},
                      model, p0)
    errs = {}
    for tag, c, g in (("float32", "cpu", "card"), ("float64", "cpu64", "card64")):
        (l_c, s_c, g_c, _, _), (l_g, s_g, g_g, _, _) = runs[c], runs[g]
        errs[tag] = (abs(l_g - l_c) / abs(l_c),
                     (s_g - s_c).abs().max().item() / s_c.abs().max().item(),
                     *ge2e_grad_errs(g_c, g_g))
    _, _, _, model, p0 = runs["card"]
    upd_err = 0.0
    for n, p in model.named_parameters():
        want = p0[n] - cfg.learning_rate * p.grad / (p.grad.abs() + 1e-8)  # Adam's first step
        upd_err = max(upd_err, (p.detach() - want).abs().max().item() / cfg.learning_rate)
    norm = math.sqrt(sum((g ** 2).sum().item() for g in runs["cpu64"][2].values()))
    print(f"GE2E step card vs CPU [{card}] full SpeakerEncoderConfig, batch "
          f"{tuple(batch.shape)}, TF32 off: loss {runs['cpu'][0]:.5f}; "
          + "; ".join(f"{tag}: loss rel err {e[0]:.3e} (limit {TERM_RTOL}), similarity "
                      f"matrix {e[1]:.3e} of its max (limit {SIM_RTOL}), gradients rel err "
                      f"{e[2]:.3e} (limit {F32_STEP_GRAD_RTOL if tag == 'float32' else GRAD_RTOL})"
                      f", similarity gradients abs err {e[3]:.3e} (limit {SIM_GRAD_ATOL})"
                      for tag, e in errs.items())
          + f"; global norm after the scaling and clip {norm:.4f} (clip at {st.CLIP_NORM}); the "
          f"first update "
          f"against Adam's formula {upd_err:.3e} of lr (limit {UPDATE_RTOL}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for tag, (l_e, s_e, g_e, sg_e) in errs.items():
        limit = F32_STEP_GRAD_RTOL if tag == "float32" else GRAD_RTOL
        check(l_e <= TERM_RTOL and s_e <= SIM_RTOL, f"GE2E step {tag}: loss {l_e}, sim {s_e}")
        check(g_e <= limit and sg_e <= SIM_GRAD_ATOL,
              f"GE2E step {tag}: gradients {g_e}, similarity gradients {sg_e}")
    check(upd_err <= UPDATE_RTOL, f"GE2E Adam update against its formula {upd_err}")

    # AutoVC at the full AutoVCConfig, train-autovc's batch; the content
    # term runs through the running statistics the forward has updated
    t0 = time.perf_counter()
    acfg = AutoVCConfig()
    x = torch.from_numpy(rng.rand(AUTOVC_BATCH, AUTOVC_FRAMES, acfg.num_mels).astype(np.float32))
    emb = torch.from_numpy(rng.randn(AUTOVC_BATCH, acfg.dim_emb).astype(np.float32))
    emb = emb / emb.norm(dim=1, keepdim=True)
    base = seeded(lambda: AutoVC(acfg), SEED + 41).train()

    def autovc_run(d, dt):
        model = copy.deepcopy(base).to(d, dt)
        terms = at.make_autovc_step(model, make_optimizer(model, 1e-4))(x.to(d, dt),
                                                                         emb.to(d, dt))
        return ([t.item() for t in terms],
                {n: p.grad.cpu().double() for n, p in model.named_parameters()},
                {n: b.cpu().double() for n, b in model.named_buffers() if "running" in n})

    runs = {name: autovc_run(d, dt) for name, d, dt in (
        ("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
        ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64))}
    errs = {}
    for tag, c, g in (("float32", "cpu", "card"), ("float64", "cpu64", "card64")):
        (t_c, g_c, s_c), (t_g, g_g, s_g) = runs[c], runs[g]
        errs[tag] = (max(abs(a - b) / abs(a) for a, b in zip(t_c, t_g)),
                     *vae_grad_errs(g_c, g_g, autovc_pre_bn_bias),
                     max((s_c[n] - s_g[n]).abs().max().item() for n in s_c))
    updated = BatchNorm.updated_stats
    BatchNorm.updated_stats = lambda self, *a: tuple(t.detach() for t in updated(self, *a))
    try:
        shortcut = vae_grad_errs(runs["cpu64"][1], autovc_run(dev, torch.float64)[1],
                                 autovc_pre_bn_bias)[0]
    finally:
        BatchNorm.updated_stats = updated
    t_c = runs["cpu"][0]
    print(f"AutoVC step card vs CPU [{card}] full AutoVCConfig, batch {AUTOVC_BATCH} x "
          f"{AUTOVC_FRAMES} frames, TF32 off: total {t_c[0]:.5f} (recon {t_c[1]:.5f}, "
          f"recon_post {t_c[2]:.5f}, content {t_c[3]:.5f}); "
          + "; ".join(f"{tag}: terms rel err {e[0]:.3e} (limit {TERM_RTOL}), gradients rel "
                      f"err {e[1]:.3e} (limit {F32_STEP_GRAD_RTOL if tag == 'float32' else GRAD_RTOL}),"
                      f" decoder/postnet pre-BN conv biases' share {e[2]:.3e} (limit "
                      f"{PRE_BN_BIAS_SHARE}), running stats abs err {e[3]:.3e} (limit "
                      f"{STATS_ATOL})" for tag, e in errs.items())
          + f"; the step without the gradient through the running statistics (float64, "
          f"card) against the CPU's: {shortcut:.3e} (must exceed {10 * GRAD_RTOL}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for tag, (t_e, g_e, b_e, s_e) in errs.items():
        limit = F32_STEP_GRAD_RTOL if tag == "float32" else GRAD_RTOL
        check(t_e <= TERM_RTOL and s_e <= STATS_ATOL, f"AutoVC step {tag}: terms {t_e}, "
              f"stats {s_e}")
        check(g_e <= limit and b_e <= PRE_BN_BIAS_SHARE,
              f"AutoVC step {tag}: gradients {g_e}, pre-BN biases {b_e}")
    check(shortcut > 10 * GRAD_RTOL,
          f"AutoVC step without the path through the statistics passes ({shortcut})")

    wav, sr = read_wav(wav_path)
    sd = st.create_speaker_encoder(cfg, SEED + 42, "cpu").state_dict()
    embeds = []
    for d in ("cpu", dev):
        embedder = SpeakerEmbedder(cfg, device=d)
        embedder.load(sd)
        embeds.append(embedder.embed_utterance(wav, return_partials=True))
    e_err = float(np.abs(embeds[0][0] - embeds[1][0]).max())
    p_err = float(np.abs(embeds[0][1] - embeds[1][1]).max())
    print(f"embed_utterance card vs CPU [{card}] {os.path.basename(wav_path)} ({len(wav) / sr:.2f}"
          f" s, {len(embeds[1][1])} partials of {cfg.partials_n_frames} frames): embedding max "
          f"abs err {e_err:.3e}, partials {p_err:.3e} (limit {EMBED_CARD_ATOL})", flush=True)
    check(np.isfinite(embeds[1][0]).all() and abs(np.linalg.norm(embeds[1][0]) - 1) < 1e-5,
          "embed_utterance on the card not a unit vector")
    check(max(e_err, p_err) <= EMBED_CARD_ATOL, f"embed_utterance card vs CPU {e_err}, {p_err}")


def speaker_step_timings(card, dev):
    """Phase 13 (ii): ms a step, peak memory above what was held, TFLOP/s
    against the float32 bound and the idle share over 3 profiled steps, of
    the GE2E step at (64, 10, 63, 80) and the AutoVC step at 8 x 64."""
    from dvc_tpu_torch.config import AutoVCConfig, SpeakerEncoderConfig
    from dvc_tpu_torch.train import autovc_trainer as at
    from dvc_tpu_torch.train import speaker_trainer as st
    from dvc_tpu_torch.train.trainer import make_optimizer
    g = torch.Generator(device=dev).manual_seed(5)
    cfg, acfg = SpeakerEncoderConfig(), AutoVCConfig()
    enc = st.create_speaker_encoder(cfg, SEED, dev)
    batch = torch.rand(cfg.speakers_per_batch, cfg.utterances_per_speaker,
                       cfg.partials_n_frames, cfg.mel_n_channels, device=dev, generator=g)
    ge2e_step = st.make_ge2e_step(enc, make_optimizer(enc, cfg.learning_rate))
    autovc, opt = at.create_autovc(acfg, device=dev)
    x = torch.rand(AUTOVC_BATCH, AUTOVC_FRAMES, acfg.num_mels, device=dev, generator=g)
    emb = torch.nn.functional.normalize(
        torch.randn(AUTOVC_BATCH, acfg.dim_emb, device=dev, generator=g), dim=1)
    autovc_step = at.make_autovc_step(autovc, opt)
    iters = 20
    for name, step, flops in (
            (f"GE2E (3 x LSTM 256), batch {tuple(batch.shape)}",
             lambda: ge2e_step(batch, with_sim=False), step_flops(enc, "ge2e", batch)),
            (f"AutoVC (full AutoVCConfig), batch {AUTOVC_BATCH} x {AUTOVC_FRAMES} frames",
             lambda: autovc_step(x, emb).total, step_flops(autovc, "autovc", x))):
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held_gb = torch.cuda.memory_allocated(dev) / 1e9
        _, ms = events_ms(lambda: [step() for _ in range(iters)])
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        loss = step().item()
        check(math.isfinite(loss), f"{name}: loss not finite")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, p_ms = events_ms(lambda: [step() for _ in range(3)])
        busy_us = device_busy_us(prof)
        bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:3]
        idle = (f"device busy {busy_us / 1e3:.1f} of {p_ms:.1f} ms (idle share "
                f"{1 - busy_us / (p_ms * 1e3):.3f}; busy {busy_us / 3e3:.2f} ms a step against "
                f"the unprofiled {ms / iters:.2f})" if busy_us > 0
                else "device busy not measured (no device time recorded)")
        idle += "; host ops by self CPU time a step: " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 3e3:.2f} ms" for e in host)
        print(f"train step [{card}] {name}, float32 (TF32 off): {ms / iters:.2f} ms a step "
              f"(mean of {iters}), {flops / 1e9:.1f} GFLOP a step (forward and backward), "
              f"{flops / (ms / iters / 1e3) / 1e12:.2f} TFLOP/s, float32 bound {bound_ms:.2f} "
              f"ms ({bound_ms / (ms / iters):.3f} of it); peak memory {peak_gb:.2f} GB "
              f"({peak_gb - held_gb:.2f} GB above the {held_gb:.2f} GB held); the profiler over "
              f"3 steps: {idle}", flush=True)


def speaker_phase(card, dev, recipe):
    """Phase 13: the GE2E speaker encoder and the AutoVC baseline.  (iii)'s
    children start first, (i) runs beside them, (ii) alone after them."""
    kids = Children(recipe)
    try:
        speaker_steps(card, dev, recipe, kids)
    finally:
        kids.kill_all()


def speaker_steps(card, dev, recipe, kids):
    from dvc_tpu_torch.config import AutoVCConfig, SpeakerEncoderConfig
    from dvc_tpu_torch.models.autovc import AutoVC
    from dvc_tpu_torch.train.autovc_trainer import load_autovc_state
    from dvc_tpu_torch.train.speaker_trainer import SpeakerEncoderTrainer
    from dvc_tpu_torch.utils import msgpack
    t0 = time.perf_counter()
    train_dir, held_dir = ge2e_corpus(os.path.join(recipe, "ge2e"))
    models = os.path.join(recipe, "ge2e_models")
    mels10 = os.path.join(recipe, "mels_no_trim")
    wav16 = os.path.join(recipe, "vctk", "VCTK-Corpus", "wav16")
    print(f"GE2E corpus [{card}]: {GE2E_SPEAKERS} speakers x {GE2E_TRAIN_UTTS} training and "
          f"{GE2E_HELD_UTTS} held-out mels of 70-200 frames ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    kids.start("train_speaker", ["train-speaker", "ge2e", train_dir, "-m", models,
                                 "--n_steps", str(GE2E_STEPS), "--save_every", "100",
                                 "--backup_every", str(GE2E_STEPS), "--umap_every", "100"])
    autovc_runs = {"autovc_onehot": os.path.join(recipe, "autovc_onehot"),
                   "autovc_ge2e": os.path.join(recipe, "autovc_ge2e")}
    autovc_args = ["--dataset_fp", mels10, "--epochs", "2", "--batch-size", str(AUTOVC_BATCH),
                   "--report-interval", "1", "--seed", str(SEED)]
    kids.start("autovc_onehot", ["train-autovc", *autovc_args, "--log_dir",
                                 autovc_runs["autovc_onehot"]])
    # the encoder's initial weights (train-speaker's, seed 0) as a run of their own
    SpeakerEncoderTrainer(SpeakerEncoderConfig(), run_id="ge2e_init", models_dir=models,
                          device=dev).save()
    wav_path = os.path.join(wav16, "p225", sorted(os.listdir(os.path.join(wav16, "p225")))[0])
    speaker_steps_against_cpu(card, dev, wav_path)

    said, secs = kids.wait("train_speaker")
    logged = [ln for ln in said.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in logged]
    batch_eers = [float(ln.split("EER ")[1].split()[0]) for ln in logged]
    have = sorted(os.listdir(models))
    viz = sorted(os.listdir(os.path.join(models, "viz")))
    check(f"device-resident pool: {GE2E_SPEAKERS * GE2E_TRAIN_UTTS} utterances" in said,
          f"train-speaker: {said[-1500:]}")
    check(len(losses) == GE2E_STEPS // 10 and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"train-speaker losses {losses}")
    check(have == ["ge2e.msgpack", f"ge2e_bak_{GE2E_STEPS:06d}.msgpack", "ge2e_init.msgpack",
                   "viz"] and {"ge2e_params.json", "ge2e_dataset.json"} <= set(viz),
          f"train-speaker wrote {have}, viz {viz}")
    print(f"train-speaker [{card}]: child process {secs:.1f} s (start to exit, train-autovc "
          f"beside it), {GE2E_STEPS} steps at {GE2E_SPEAKERS} x 10 x 63 on the resident pool; "
          f"logged loss {losses[0]:.4f} -> {losses[-1]:.4f}, batch EER {batch_eers[0]:.4f} -> "
          f"{batch_eers[-1]:.4f}; {logged[-1]}; {', '.join(have)}; viz {', '.join(viz)}",
          flush=True)

    for run_id in ("ge2e", "ge2e_init"):
        kids.start(f"eval_eer_{run_id}", ["eval-eer", run_id, held_dir, "-m", models])
    kids.start("embed", ["embed", "ge2e", wav16, "-m", models, "-o",
                         os.path.join(recipe, "embeds")])
    kids.start("autovc_ge2e", ["train-autovc", *autovc_args, "--log_dir",
                               autovc_runs["autovc_ge2e"], "--encoder_run_id", "ge2e",
                               "-m", models])
    eers = {}
    for run_id in ("ge2e", "ge2e_init"):
        said, secs = kids.wait(f"eval_eer_{run_id}")
        line = [ln for ln in said.splitlines() if ln.startswith("verification EER")]
        check(len(line) == 1, f"eval-eer {run_id}: {said[-1500:]}")
        eers[run_id] = float(line[0].rsplit(" ", 1)[1])
        print(f"eval-eer [{card}] {run_id} on the held-out mels: child process {secs:.1f} s; "
              f"{line[0]}", flush=True)
    check(eers["ge2e"] < eers["ge2e_init"],
          f"trained EER {eers['ge2e']} not below the initial weights' {eers['ge2e_init']}")
    said, secs = kids.wait("embed")
    out = os.path.join(recipe, "embeds")
    files = sorted(os.listdir(out))
    n_wavs = sum(len(fs) for _, _, fs in os.walk(wav16))
    embeds = np.stack([np.load(os.path.join(out, f)) for f in files])
    check(len(files) == n_wavs and embeds.shape[1] == 256 and np.isfinite(embeds).all()
          and np.allclose(np.linalg.norm(embeds, axis=1), 1.0, atol=1e-5),
          f"embed wrote {len(files)} files for {n_wavs} wavs")
    print(f"embed [{card}]: child process {secs:.1f} s; {said.strip().splitlines()[-1]}; "
          f"{len(files)} unit-norm (256,) embeddings", flush=True)
    for name, run in autovc_runs.items():
        said, secs = kids.wait(name)
        losses = [float(ln.split("loss ")[1]) for ln in said.splitlines()
                  if ln.startswith("====> AutoVC epoch")]
        have = sorted(os.listdir(run))
        check(len(losses) == 2 and all(map(math.isfinite, losses)) and losses[1] < losses[0],
              f"{name} epoch losses {losses}: {said[-1500:]}")
        check(have == ["autovc_1.msgpack", "autovc_2.msgpack"], f"{name} wrote {have}")
        with open(os.path.join(run, "autovc_2.msgpack"), "rb") as f:
            step = load_autovc_state(msgpack.unpackb(f.read()), AutoVC(AutoVCConfig()))
        print(f"train-autovc [{card}] {name}: child process {secs:.1f} s; epoch losses "
              f"{losses}; {', '.join(have)} (step {step})", flush=True)
    speaker_step_timings(card, dev)


WORLD_AGREE_MIN = 0.99   # phase 14 (i): Harvest card against CPU, voicing agreement, and
WORLD_F0_MEDIAN = 1e-4   # the median relative f0 error on frames voiced in both (the CPU
                         # reads 1e-6 against dvc_tpu: tests/test_torch_port_harvest.py)
NATIVE_AGREE_MIN = 0.93  # phase 14 (i): Harvest against the native engine, per wav: the
NATIVE_F0_MEDIAN = 0.01  # realistic (voiced-silence-voiced) gates of tests/test_harvest_tpu.py
WORLD_MC_RANGE = 1e-3    # phase 14 (ii): world_decompose_batch's mc card against CPU, of
                         # its range (the CPU test's limit against dvc_tpu)
WORLD_SYNTH_RTOL = 1e-4  # phase 14 (ii): synthesize_batch card against CPU, the same noise,
                         # of the peak (tests/test_torch_port_world_synthesis.py: 1e-5)
WORLD_NORM_MEDIAN = 0.05  # phase 14 (iii): preprocess-world --f0 device against native: the
                          # median over frames of normalized_mc's largest difference (in
                          # speaker standard deviations; voicing flips move single frames)
WORLD_MCD_RTOL = 0.05    # phase 14 (iii): eval-mcd --analysis device against native: dvc_tpu's
                         # own gate (tests/test_eval.py, per utterance on tones), held on the
                         # mean MCD eval-mcd reports; per utterance it is reported only, since
                         # dvc_tpu's own device analysis is 7.1% off its native one on one of
                         # these converted utterances on the CPU, as the port's is (PERF.md)


def world_phase(card, dev, recipe):
    """Phase 14: the WORLD route on the card, on phase 10's corpus.  (iii)'s
    children start first, (i) and (ii) run beside them."""
    kids = Children(recipe)
    try:
        world_steps(card, dev, recipe, kids)
    finally:
        kids.kill_all()


def world_steps(card, dev, recipe, kids):
    from dvc_tpu_torch.native import world as native_world
    from dvc_tpu_torch.ops import harvest as ph
    from dvc_tpu_torch.ops import world as pw
    from dvc_tpu_torch.ops.audio import resample_poly
    from dvc_tpu_torch.utils.wavio import parse_wav, read_wav, wav_bytes
    sync = torch.cuda.synchronize
    wav16 = os.path.join(recipe, "vctk", "VCTK-Corpus", "wav16")
    world = {m: os.path.join(recipe, f"world_{m}") for m in ("native", "device")}
    run = os.path.join(recipe, "run_mcc")

    # (iii) preprocess-world in both modes, as two children at once
    for m in world:
        kids.start(f"preprocess_world_{m}", ["preprocess-world", wav16, "-o", world[m],
                                             "--f0", m])

    # (i) Harvest and the batched analysis on the card, timed; the CPU's
    # in a thread beside the children
    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(wav16) for f in fs)
    wavs = []
    for p in paths:
        w, sr = read_wav(p)
        wavs.append(w if sr == 16000 else resample_poly(torch.from_numpy(w), sr, 16000).numpy())
    audio_s = sum(len(w) for w in wavs) / 16000
    pw.world_decompose_batch(wavs[:2], 16000, keep_sp_ap=False, device=dev)  # warm-up
    spent = {"harvest_batch": 0.0, "_extend": 0.0, "_smooth_segments": 0.0}
    real = {name: getattr(ph, name) for name in spent}

    def timed(name):
        def fn(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = real[name](*a, **k)
            sync()
            spent[name] += time.perf_counter() - t0
            return out
        return fn

    for name in spent:
        setattr(ph, name, timed(name))
    try:
        card_res = pw.world_decompose_batch(wavs, 16000, keep_sp_ap=False, device=dev)
    finally:
        for name, fn in real.items():
            setattr(ph, name, fn)
    sync()
    t0 = time.perf_counter()
    pw.world_decompose_batch(wavs, 16000, keep_sp_ap=False, device=dev)
    sync()
    dec_s = time.perf_counter() - t0
    scans = spent["_extend"] + spent["_smooth_segments"]
    print(f"harvest_batch [{card}]: {len(wavs)} wavs, {audio_s:.1f} s of audio, in "
          f"{spent['harvest_batch']:.2f} s ({audio_s / spent['harvest_batch']:.1f} s of audio a "
          f"second; host clock, synchronized at each call): the two frame scans "
          f"{scans:.2f} s of it, a share of {scans / spent['harvest_batch']:.3f} (_extend "
          f"{spent['_extend']:.2f} s, _smooth_segments {spent['_smooth_segments']:.2f} s); "
          f"world_decompose_batch {dec_s:.2f} s ({audio_s / dec_s:.1f} s of audio a second, "
          f"host clock, unsynchronized inside)", flush=True)

    # the native engine's f0 at the realistic gates
    with ThreadPoolExecutor(8) as pool:
        nat = list(pool.map(lambda w: native_world.harvest(w, 16000, 5.0)[0], wavs))
    n_agree, n_med = [], []
    for (f0, *_), fn in zip(card_res, nat):
        f0 = f0[:len(fn)]
        both = (f0 > 0) & (fn > 0)
        n_agree.append(float(((f0 > 0) == (fn > 0)).mean()))
        n_med.append(float(np.median(np.abs(f0[both] - fn[both]) / fn[both])) if both.any()
                     else math.inf)
    print(f"harvest_batch against the native engine [{card}]: per wav voicing agreement min "
          f"{min(n_agree):.4f} (limit {NATIVE_AGREE_MIN}), median relative error max "
          f"{max(n_med):.3e} (limit {NATIVE_F0_MEDIAN})", flush=True)
    check(min(n_agree) >= NATIVE_AGREE_MIN and max(n_med) < NATIVE_F0_MEDIAN,
          f"card Harvest against native: agreement {min(n_agree)}, median {max(n_med)}")

    # (ii) synthesize_batch card against CPU, the same noise, on the card's
    # features of 8 wavs with the conversion's flat aperiodicity
    feats = []
    for f0, _, _, _, mc in card_res[:8]:
        sp = pw.world_decode_mc(mc, 16000, device=dev)
        ap = np.full(sp.shape, 0.2, np.float32)
        ap[f0 == 0] = 1.0 - 1e-12
        feats.append((f0, sp, ap))
    args = [[f[k] for f in feats] for k in range(3)]
    want = pw.synthesize_batch(*args, 16000, device="cpu")
    pw.synthesize_batch(*args, 16000, device=dev)  # warm-up
    sync()
    t0 = time.perf_counter()
    got = pw.synthesize_batch(*args, 16000, device=dev)
    syn_s = time.perf_counter() - t0
    n_batches = len({-(-len(f0) // 256) for f0 in args[0]})
    syn_err = max(rel_err(torch.from_numpy(g), torch.from_numpy(w)) for g, w in zip(got, want))
    print(f"synthesize_batch card vs CPU [{card}] {len(got)} utterances in {n_batches} "
          f"batches: max err {syn_err:.3e} of the peak (limit {WORLD_SYNTH_RTOL}); "
          f"{syn_s * 1e3 / n_batches:.1f} ms a batch on the card (host clock, to the "
          f"waveforms on the host)", flush=True)
    check(all(g.shape == w.shape for g, w in zip(got, want)) and syn_err <= WORLD_SYNTH_RTOL,
          f"synthesize_batch card against CPU {syn_err}")

    # (iii) train --features mcc on the device's features (the faster child),
    # 2 epochs at batch 8; (i)'s CPU reference in a thread from here on,
    # beside the children
    said, secs = {}, {}
    said["pre_device"], secs["preprocess-world device"] = kids.wait("preprocess_world_device")
    kids.start("train_mcc", ["train", "--features", "mcc", "--dataset_fp", world["device"],
                             "--log_dir", run, "--epochs", "2", "--batch-size", "8",
                             "--report-interval", "2", "--seed", str(SEED)])
    said["pre_native"], secs["preprocess-world native"] = kids.wait("preprocess_world_native")
    cpu_out = {}

    def on_cpu():
        t0 = time.perf_counter()
        cpu_out["res"] = pw.world_decompose_batch(wavs, 16000, keep_sp_ap=False, device="cpu")
        cpu_out["s"] = time.perf_counter() - t0

    cpu_thread = threading.Thread(target=on_cpu, daemon=True)
    cpu_thread.start()
    for m in world:
        check(said[f"pre_{m}"].count(" files, logf0 ") == len(RECIPE_SPEAKERS),
              f"preprocess-world {m}: {said[f'pre_{m}'][-1500:]}")
    diffs, n_files, f_agree = [], 0, []
    for spk in RECIPE_SPEAKERS:
        names = sorted(os.listdir(os.path.join(world["native"], spk)))
        check(names == sorted(os.listdir(os.path.join(world["device"], spk)))
              and len(names) == 12, f"preprocess-world wrote {names}")
        for name in names:
            with np.load(os.path.join(world["native"], spk, name)) as a, \
                    np.load(os.path.join(world["device"], spk, name)) as b:
                check(sorted(a.files) == sorted(b.files) == ["f0", "mc_mean", "mc_std", "mcc",
                                                             "normalized_mc"]
                      and a["normalized_mc"].shape == b["normalized_mc"].shape
                      and np.isfinite(b["normalized_mc"]).all(), f"preprocess-world {name}")
                diffs.append(np.abs(a["normalized_mc"] - b["normalized_mc"]).max(1))
                f_agree.append(float(((a["f0"] > 0) == (b["f0"] > 0)).mean()))
                n_files += 1
    d = np.concatenate(diffs)
    print(f"preprocess-world [{card}]: native child {secs['preprocess-world native']:.1f} s, "
          f"device child {secs['preprocess-world device']:.1f} s (at once), {n_files} files "
          f"each; normalized_mc device against native: per-frame largest difference median "
          f"{np.median(d):.3e} (limit {WORLD_NORM_MEDIAN}), 99th percentile "
          f"{np.percentile(d, 99):.3e}, max {d.max():.3e}; voicing agreement min "
          f"{min(f_agree):.4f}", flush=True)
    check(np.median(d) <= WORLD_NORM_MEDIAN, f"normalized_mc device against native {np.median(d)}")

    said["train"], secs["train --features mcc"] = kids.wait("train_mcc")
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in said["train"].splitlines()
              if "Epoch" in ln]
    have = sorted(os.listdir(os.path.join(run, "checkpoints")))
    check(len(losses) == 2 and all(map(math.isfinite, losses))
          and have == [f"DisentangledVAE_VCTK_2{s}" for s in (".msgpack", ".opt.pth", ".pth")],
          f"train --features mcc: losses {losses}, wrote {have}: {said['train'][-1500:]}")
    print(f"train --features mcc [{card}]: child {secs['train --features mcc']:.1f} s, 2 "
          f"epochs at batch 8 of 128 frames x 36 MCCs, losses {losses}; {', '.join(have)}",
          flush=True)

    # convert-world with both synthesizers and serve --pipeline world, at once
    common = ["--dataset_fp", world["device"], "--log_dir", run, "--num_utterances", "4"]
    kids.start("convert_world_native", ["convert-world", *common, "--src_spk", "p225",
                                        "--trg_spk", "p226"])
    kids.start("convert_world_device", ["convert-world", *common, "--src_spk", "p227",
                                        "--trg_spk", "p226", "--synth", "device"])
    port = free_port()
    t0 = time.perf_counter()
    proc = start_serve(["--pipeline", "world", "--dataset_fp", world["device"], "--log_dir",
                        run, "--max_wait_ms", "500"], port, dev.type,
                       os.path.join(recipe, "serve_world.log"))
    up_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{port}/convert?trg_spk=p226"

    def post(data):
        req = urllib.request.Request(url, data=data, method="POST")
        t_req = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), time.perf_counter() - t_req

    src = [read_wav(p)[0][:16000] for p in paths[:3]]  # 1 s of three p225 wavs
    bodies = [wav_bytes(src[0], 16000),
              wav_bytes(resample_poly(torch.from_numpy(src[1]), 16000, 22050).numpy(), 22050),
              wav_bytes(src[2], 16000)]
    try:
        post(bodies[0])  # warm-up: cuDNN and cuFFT plans
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            replies = list(pool.map(post, bodies))
        serve_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        stop(proc)
    for (status, data, _), body in zip(replies, bodies):
        w, sr = parse_wav(data)
        x, sr_in = parse_wav(body)
        n = -(-len(x) * 16000 // sr_in)
        check(status == 200 and sr == 16000 and w.shape == ((n // 80 + 1) * 80,)
              and np.isfinite(w).all() and w.std() > 1e-3,
              f"serve --pipeline world: reply {status}, {w.shape} at {sr} Hz for {n} samples")
    print(f"serve --pipeline world [{card}]: up in {up_s:.1f} s; 3 concurrent POST /convert "
          f"of 1 s (one at 22.05 kHz) answered 200 with 16 kHz wavs in {serve_s:.3f} s "
          f"(client clock; latencies {', '.join(f'{r[2]:.3f}' for r in replies)} s); "
          f"{stats['requests']} requests in {stats['batches']} batches", flush=True)

    gen = os.path.join(run, "generation_world")
    for m, pair in (("native", "p225_to_p226"), ("device", "p227_to_p226")):
        said[m], secs[f"convert-world --synth {m}"] = kids.wait(f"convert_world_{m}")
        files = sorted(os.listdir(os.path.join(gen, pair)))
        check(len(files) == 4 and said[m].count("wrote ") == 4, f"convert-world {m}: {files}")
        for f in files:
            w, sr = read_wav(os.path.join(gen, pair, f))
            check(sr == 16000 and np.isfinite(w).all() and 0.9 < np.abs(w).max() <= 1.0,
                  f"convert-world {m}: {f}")
    for m in ("device", "native"):
        kids.start(f"eval_mcd_{m}", ["eval-mcd", "--src_dir", os.path.join(wav16, "p225"),
                                     "--cvt_dir", os.path.join(gen, "p225_to_p226"),
                                     "--analysis", m])
    mcd = {}
    for m in ("device", "native"):
        said[m], secs[f"eval-mcd --analysis {m}"] = kids.wait(f"eval_mcd_{m}")
        mcd[m] = {ln.split()[1]: float(ln.split("mcd: ")[1]) for ln in said[m].splitlines()
                  if ln.startswith("utterance ")}
    check(len(mcd["device"]) == 4 and mcd["device"].keys() == mcd["native"].keys()
          and all(map(math.isfinite, mcd["device"].values())), f"eval-mcd printed {mcd}")
    rel = {k: abs(mcd["device"][k] - v) / v for k, v in mcd["native"].items()}
    means = {m: float(np.mean(list(mcd[m].values()))) for m in mcd}
    mean_rel = abs(means["device"] - means["native"]) / means["native"]
    print(f"eval-mcd [{card}] on convert-world's 4 wavs: --analysis device "
          f"{json.dumps(mcd['device'])}, native {json.dumps(mcd['native'])}; the mean MCD "
          f"device {means['device']:.4f}, native {means['native']:.4f}, relative difference "
          f"{mean_rel:.4f} (limit {WORLD_MCD_RTOL}); per utterance max "
          f"{max(rel.values()):.4f} (reported)", flush=True)
    check(mean_rel <= WORLD_MCD_RTOL, f"eval-mcd device against native: mean {means}")

    cpu_thread.join(600)
    check("res" in cpu_out, "the CPU analysis did not finish")
    agree, med, mc_err = [], [], 0.0
    for (f0c, _, _, _, mcc), (f0g, _, _, _, mcg) in zip(cpu_out["res"], card_res):
        both = (f0c > 0) & (f0g > 0)
        agree.append(float(((f0c > 0) == (f0g > 0)).mean()))
        med.append(float(np.median(np.abs(f0g[both] - f0c[both]) / f0c[both])))
        mc_err = max(mc_err, float(np.abs(mcg - mcc).max() / np.ptp(mcc)))
    print(f"harvest_batch card vs CPU [{card}] on the {len(wavs)} wavs: voicing agreement "
          f"min {min(agree):.4f} (limit {WORLD_AGREE_MIN}), median relative error max "
          f"{max(med):.3e} (limit {WORLD_F0_MEDIAN}); world_decompose_batch mc max err "
          f"{mc_err:.3e} of its range (limit {WORLD_MC_RANGE}); the CPU run {cpu_out['s']:.1f} s "
          f"beside the children", flush=True)
    check(min(agree) >= WORLD_AGREE_MIN and max(med) <= WORLD_F0_MEDIAN,
          f"Harvest card against CPU: agreement {min(agree)}, median {max(med)}")
    check(mc_err <= WORLD_MC_RANGE, f"world_decompose_batch mc card against CPU {mc_err}")
    print(f"WORLD children [{card}] (seconds, start to exit): "
          f"{json.dumps({k: round(v, 1) for k, v in secs.items()})}", flush=True)


PARALLEL_TIMEOUT_S = 300  # phase 15's two-card ranks: start-up, NCCL and four full-width steps
LONG_CONTEXT_RTOL = 1e-4  # phase 15 (iii), card against CPU: phase 12's long-context limit
CONV_RTOL = 2e-5          # the halo conv against F.conv1d (tests/test_sequence_parallel.py)
CLI_LOSS_RTOL = 1e-3      # torchrun train's epoch losses against one process's: four Adam
                          # steps, each of which may step a rounding-noise gradient either way


def mesh_step_against_plain(card, dev):
    """Phase 15 (i): Trainer's mesh branch (use_mesh, the default) on the
    one-rank NCCL group at the full VAEConfig and bench.py's batch, against
    the plain step (use_mesh=False) from the same weights, batch and step
    seed: the loss terms, every gradient, the BN statistics; then both timed
    in turns (plain, mesh, mesh, plain) and the mesh step's peak memory."""
    from dvc_tpu_torch.config import Config, TrainConfig
    from dvc_tpu_torch.parallel.tensor import MeshAdam
    from dvc_tpu_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    cfg = Config(train=TrainConfig(batch_size=BENCH_BATCH, seed=SEED))
    plain, mesh = Trainer(cfg, use_mesh=False, device=dev), Trainer(cfg, device=dev)
    check(plain.mesh is None and mesh.mesh is not None and isinstance(mesh.optimizer, MeshAdam),
          "the default Trainer did not take its mesh branch under a process group")
    g = torch.Generator(device=dev).manual_seed(15)
    x1, x2 = (torch.rand(BENCH_BATCH, 80, BENCH_FRAMES, device=dev, generator=g)
              for _ in range(2))
    t_p, t_m = plain.step_on(x1, x2), mesh.step_on(x1, x2)
    term_err = max(abs(a.item() - b.item()) / max(abs(a.item()), 1e-12) for a, b in zip(t_p, t_m))
    grad_err, bias_share = vae_grad_errs(
        {n: p.grad.cpu() for n, p in plain.model.named_parameters()},
        {n: p.grad.cpu() for n, p in mesh.model.named_parameters()})
    stats_m = dict(mesh.model.named_buffers())
    stat_err = max((b - stats_m[n]).abs().max().item()
                   for n, b in plain.model.named_buffers() if "running" in n)
    print(f"mesh step vs plain step [{card}] one-rank NCCL group, full width, batch "
          f"{BENCH_BATCH} x {BENCH_FRAMES}, the defaults (bfloat16 inputs, pair_fused): loss "
          f"{t_p.total.item():.3f}; loss terms rel err {term_err:.3e} (limit {TERM_RTOL}), "
          f"gradients rel err {grad_err:.3e} (limit {GRAD_RTOL}), pre-BN conv biases' share "
          f"{bias_share:.3e} (limit {PRE_BN_BIAS_SHARE}), BN running stats max err "
          f"{stat_err:.3e} (limit {STATS_ATOL})", flush=True)
    check(term_err <= TERM_RTOL, f"the mesh step's loss terms differ: {term_err}")
    check(grad_err <= GRAD_RTOL, f"the mesh step's gradients differ: {grad_err}")
    check(bias_share <= PRE_BN_BIAS_SHARE, f"mesh step pre-BN bias gradients not ~0: {bias_share}")
    check(stat_err <= STATS_ATOL, f"the mesh step's BN statistics differ: {stat_err}")
    iters, ms = 10, {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        tr = plain if name == "plain" else mesh
        for _ in range(2):
            tr.step_on(x1, x2)
        torch.cuda.synchronize()
        if name == "mesh" and not ms["mesh"]:
            torch.cuda.reset_peak_memory_stats(dev)
            held_gb = torch.cuda.memory_allocated(dev) / 1e9
        _, t = events_ms(lambda: [tr.step_on(x1, x2) for _ in range(iters)])
        if name == "mesh" and not ms["mesh"]:
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        ms[name].append(t / iters)
    check(all(math.isfinite(t.item()) for t in mesh.step_on(x1, x2)), "mesh step loss not finite")
    p_ms, m_ms = (sum(v) / len(v) for v in (ms["plain"], ms["mesh"]))
    moments = mesh.optimizer.moment_bytes()
    print(f"mesh step timing [{card}] batch {BENCH_BATCH} x {BENCH_FRAMES}: plain "
          f"{' / '.join(f'{v:.2f}' for v in ms['plain'])} ms, mesh "
          f"{' / '.join(f'{v:.2f}' for v in ms['mesh'])} ms a step (means of {iters}, in turns "
          f"plain, mesh, mesh, plain); mesh / plain {m_ms / p_ms:.4f}; mesh peak memory "
          f"{peak_gb:.2f} GB ({peak_gb - held_gb:.2f} GB above the {held_gb:.2f} GB held, both "
          f"trainers); Adam moments on this rank {sum(h for h, _ in moments.values()) / 1e6:.1f}"
          f" MB (dp 1: none sharded); {time.perf_counter() - t0:.1f} s", flush=True)
    del plain, mesh
    torch.cuda.empty_cache()
    return {"plain_ms": p_ms, "mesh_ms": m_ms, "peak_gb": peak_gb}


def ge2e_mesh_step(card, dev):
    """Phase 15 (ii): the GE2E step with a mesh (the all-gather of the
    embeddings and the averaged gradients, here over one rank) against the
    plain step at the full SpeakerEncoderConfig, from the same weights and
    batch; SpeakerEncoderTrainer(use_mesh=True) keeps dvc_tpu's rule and
    takes no mesh on one rank."""
    from dvc_tpu_torch.config import MeshConfig, SpeakerEncoderConfig
    from dvc_tpu_torch.parallel.mesh import make_mesh
    from dvc_tpu_torch.train import speaker_trainer as st
    from dvc_tpu_torch.train.trainer import make_optimizer
    cfg = SpeakerEncoderConfig()
    g = torch.Generator(device=dev).manual_seed(16)
    batch = torch.rand(cfg.speakers_per_batch, cfg.utterances_per_speaker,
                       cfg.partials_n_frames, cfg.mel_n_channels, device=dev, generator=g)
    base = st.create_speaker_encoder(cfg, SEED + 41, dev)
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=1), dev)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        model = copy.deepcopy(base)
        step = st.make_ge2e_step(model, make_optimizer(model, cfg.learning_rate), m)
        loss = step(batch, with_sim=False).item()
        _, t = events_ms(lambda: [step(batch, with_sim=False) for _ in range(5)])
        runs[name] = (loss, {n: p.grad.cpu() for n, p in model.named_parameters()}, t / 5)
    loss_err = abs(runs["mesh"][0] - runs["plain"][0]) / abs(runs["plain"][0])
    grad_err, sim_err = ge2e_grad_errs(runs["plain"][1], runs["mesh"][1])
    tr = st.SpeakerEncoderTrainer(cfg, device=dev)
    print(f"GE2E mesh step vs plain [{card}] one-rank NCCL group, batch {tuple(batch.shape)}: "
          f"loss {runs['plain'][0]:.5f}, rel err {loss_err:.3e} (limit {TERM_RTOL}), gradients "
          f"rel err {grad_err:.3e} (limit {GRAD_RTOL}), similarity gradients abs err "
          f"{sim_err:.3e} (limit {SIM_GRAD_ATOL}); {runs['plain'][2]:.2f} / {runs['mesh'][2]:.2f} "
          f"ms a step plain / mesh (5 steps each); the trainer's mesh on one rank: {tr.mesh}",
          flush=True)
    check(loss_err <= TERM_RTOL, f"GE2E mesh step loss differs: {loss_err}")
    check(grad_err <= GRAD_RTOL, f"GE2E mesh step gradients differ: {grad_err}")
    check(sim_err <= SIM_GRAD_ATOL, f"GE2E mesh step similarity gradients differ: {sim_err}")
    check(tr.mesh is None, "SpeakerEncoderTrainer took a mesh on one rank")


def sharded_lstm_on_card(card, dev):
    """Phase 15 (i), after the mesh step: ShardedLSTM, the tensor-parallel LSTM of the mesh
    trainer (one rank's blocks of its weights, gathered over the model
    axis, run as the original nn.LSTM through torch.func.functional_call),
    over the one-rank group: the full VAE's dec_lstm2 with its weights
    placed as model_placement places them, forward and backward in training
    mode on cuDNN, against the nn.LSTM it wraps."""
    from dvc_tpu_torch.config import MeshConfig, VAEConfig
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.parallel.mesh import make_mesh, model_placement
    from dvc_tpu_torch.parallel.tensor import ShardedLSTM
    lstm = seeded(lambda: DisentangledVAE(VAEConfig()), SEED + 43).dec_lstm2.to(dev).train()
    dims = {n: getattr(model_placement(n, tuple(w.shape), 2), "dim", None)
            for n, w in lstm.named_parameters()}
    sharded = ShardedLSTM(lstm, make_mesh(MeshConfig(), dev), dims).train()
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.rand(BENCH_BATCH, BENCH_FRAMES, lstm.input_size, device=dev, generator=g)
    gy = torch.rand(BENCH_BATCH, BENCH_FRAMES, lstm.hidden_size, device=dev, generator=g)
    runs = []
    for m in (lstm, sharded):
        xi = x.clone().requires_grad_()
        y, _ = m(xi)
        (y * gy).sum().backward()
        runs.append([y.detach(), xi.grad, *(p.grad for _, p in m.named_parameters())])
    err = max(rel_err(a, b) for a, b in zip(runs[1], runs[0]))
    print(f"ShardedLSTM [{card}] one-rank model group, dec_lstm2 {lstm.input_size} -> "
          f"{lstm.hidden_size} x {lstm.num_layers} layers, ({BENCH_BATCH}, {BENCH_FRAMES}), "
          f"sharded weights {sorted(n for n, d in dims.items() if d is not None)}: output and "
          f"gradients against nn.LSTM {err:.3e} of their max (limit {TERM_RTOL})", flush=True)
    check(any(d is not None for d in dims.values()), "dec_lstm2 has no model-sharded weight")
    check(err <= TERM_RTOL, f"ShardedLSTM differs from nn.LSTM: {err}")


def long_context_mesh(card, dev):
    """Phase 15 (iii): whole_utterance_encode with a mesh (the frame-sharded
    conv stack and LSTM, over one rank) on the card against the plain
    encode on the CPU, full VAEConfig, a ragged 4-chunk utterance."""
    from dvc_tpu_torch.config import MeshConfig, VAEConfig
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.models.long_context import whole_utterance_encode
    from dvc_tpu_torch.parallel.mesh import make_mesh
    cfg = VAEConfig()
    cpu = seeded(lambda: DisentangledVAE(cfg), SEED + 42).eval()
    card_model = copy.deepcopy(cpu).to(dev)
    mel = np.random.RandomState(17).rand(1, 80, 4 * cfg.frames - 10).astype(np.float32)
    got = whole_utterance_encode(cfg, card_model, mel, make_mesh(MeshConfig(), dev))
    want = whole_utterance_encode(cfg, cpu, mel)
    err = max(rel_err(a.cpu(), b) for a, b in zip(got, want))
    print(f"whole_utterance_encode(mesh) [{card}] one-rank NCCL group, full width, "
          f"{mel.shape[-1]} frames ({got[0].shape[1]} chunks) against the CPU's plain encode: "
          f"posteriors {err:.3e} of their max (limit {LONG_CONTEXT_RTOL})", flush=True)
    check(err <= LONG_CONTEXT_RTOL, f"whole_utterance_encode(mesh) differs: {err}")



def parallel_rank(rank: int, work: str) -> int:
    """One of phase 15 (iv)'s two NCCL ranks (``chip_smoke.py --parallel-rank
    <rank> <dir>``): the full-width VAE step at batch 8, sharded dp 2 x mp 1
    (ZeRO) and dp 1 x mp 2 (tensor parallel), in float64 (models built,
    inputs and noise drawn under that default dtype: the float32 gradients
    are too ill-conditioned for a tight check, phase 12), and the halo conv
    over the frames; rank 0 holds each against the one-process result and
    writes the errors to <dir>/result.json.  After each step the state is
    saved twice (phase 16's two-card part): as an orbax checkpoint, each
    rank writing its own store, and gathered into a msgpack; rank 0 reads
    both back in one process and compares them."""
    import datetime
    import torch.distributed as dist
    from dvc_tpu_torch.config import Config, MeshConfig, TrainConfig
    from dvc_tpu_torch.parallel.collectives import gather_blocks
    from dvc_tpu_torch.parallel.mesh import Shard, data_rows, make_mesh
    from dvc_tpu_torch.parallel.multihost import initialize_distributed
    from dvc_tpu_torch.parallel.sequence import sequence_sharded_conv1d
    from dvc_tpu_torch.train.trainer import Trainer
    from dvc_tpu_torch.utils.device import use_exact_float32
    use_exact_float32()
    initialize_distributed(f"file://{work}/store", 2, rank, device="cuda",
                           timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S // 2))
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.RandomState(18)
    x1, x2 = (rng.rand(TRAIN_BATCH, 80, BENCH_FRAMES).astype(np.float32) for _ in range(2))
    out = {"cards": [torch.cuda.get_device_name(dev)], "orbax": {}}
    for mp, dt in ((1, torch.float64), (2, torch.float64)):
        cfg = Config(train=TrainConfig(batch_size=TRAIN_BATCH, seed=SEED, compute_dtype="float32"),
                     mesh=MeshConfig(model_parallel=mp))
        torch.set_default_dtype(dt)
        try:
            tr = Trainer(cfg, device=dev)
            rows = data_rows(TRAIN_BATCH, tr.mesh)
            terms = tr.step_on(*(torch.from_numpy(a[rows]).to(dev, dt) for a in (x1, x2)))
            grads = {}
            for n, p in tr.model.named_parameters():
                tp = tr.shardings["params"][n][1]
                grads[n] = (gather_blocks(p.grad, tp.dim, tr.mesh.model_group)
                            if isinstance(tp, Shard) else p.grad).cpu()
            if rank == 0:
                one = Trainer(cfg, use_mesh=False, device=dev)
                want = one.step_on(*(torch.from_numpy(a).to(dev, dt) for a in (x1, x2)))
                ge, bs = vae_grad_errs(
                    {n: p.grad.cpu() for n, p in one.model.named_parameters()}, grads)
                out[f"dp{tr.mesh.dp} x mp{tr.mesh.mp}, {str(dt).replace('torch.', '')}"] = {
                    "term_err": max(abs(a.item() - b.item()) / max(abs(a.item()), 1e-12)
                                    for a, b in zip(want, terms)),
                    "grad_err": ge, "bias_share": bs}
                del one
            out["orbax"][f"dp{tr.mesh.dp} x mp{tr.mesh.mp}"] = sharded_save_check(tr, rank, work)
            del tr
        finally:
            torch.set_default_dtype(torch.float32)
        torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(19)
    x = torch.rand(2, 512, 256, generator=g)
    w, b = torch.rand(512, 512, 5, generator=g) - 0.5, torch.rand(512, generator=g)
    mesh = make_mesh(MeshConfig(), dev)
    cols = data_rows(x.shape[-1], mesh)
    y = sequence_sharded_conv1d(x[..., cols].to(dev), w.to(dev), b.to(dev), mesh)
    y = gather_blocks(y, 2, mesh.data_group).cpu()
    if rank == 0:
        want = torch.nn.functional.conv1d(x.to(dev), w.to(dev), b.to(dev), padding=2).cpu()
        out["halo_conv_err"] = rel_err(y, want)
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_save_check(tr, rank: int, work: str) -> dict | None:
    """Trainer ``tr`` (a two-rank mesh) saved as a sharded orbax checkpoint
    (every rank its own ocdbt.process_<rank>/ store) and as the gathered
    msgpack; on rank 0 (None elsewhere) whether the two read back equal in
    one process, and each process store's key count."""
    from dvc_tpu_torch.train import checkpoint as ckpt
    from dvc_tpu_torch.utils import ocdbt
    tag = f"dp{tr.mesh.dp}mp{tr.mesh.mp}"
    tr.step = 1
    paths = {}
    t0 = time.perf_counter()
    for fmt in ("orbax", "msgpack"):
        tr.cfg = tr.cfg.replace(train=dataclasses.replace(tr.cfg.train, checkpoint_format=fmt))
        tr.checkpoints_path = os.path.join(work, f"{tag}_{fmt}")
        tr.save(1)
        paths[fmt] = os.path.join(tr.checkpoints_path, f"{ckpt.RUN_NAME}_1.{fmt}")
        if fmt == "orbax":
            sharded_s = time.perf_counter() - t0
    if rank != 0:
        return None
    stores = [len(ocdbt.read_entries(os.path.join(paths["orbax"], f"ocdbt.process_{r}")))
              for r in range(2)]
    return {"equal": trees_equal(ckpt.read_train_state(paths["orbax"]),
                                 ckpt.read_train_state(paths["msgpack"])),
            "stores": stores, "sharded_s": sharded_s}


def two_card_check(card, work):
    """Phase 15 (iv): with two or more cards, parallel_rank on cards 0 and 1
    as two processes, within PARALLEL_TIMEOUT_S."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise SystemExit(f"chip_smoke: FAILED: two-card ranks not done in {PARALLEL_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          "two-card ranks failed: " + " | ".join(log[-2000:] for log in logs))
    with open(os.path.join(work, "result.json")) as f:
        res = json.load(f)
    failed = []
    for key, e in res.pop("orbax").items():
        print(f"two-card orbax save [{card}] {key}: each rank wrote its own store "
              f"({e['stores']} keys) in {e['sharded_s']:.2f} s; read back in one process, "
              f"equal to the gathered msgpack state: {e['equal']}", flush=True)
        if not (e["equal"] and min(e["stores"]) > 0):
            failed.append(f"orbax {key}")
    for key, e in res.items():
        if not isinstance(e, dict):
            continue
        print(f"two-card VAE step [{card}] NCCL, {key}, full width, batch {TRAIN_BATCH}, "
              f"against one process: loss terms {e['term_err']:.3e} (limit {TERM_RTOL}), "
              f"gradients {e['grad_err']:.3e} (limit {GRAD_RTOL}), pre-BN bias share "
              f"{e['bias_share']:.3e} (limit {PRE_BN_BIAS_SHARE})", flush=True)
        if not (e["term_err"] <= TERM_RTOL and e["grad_err"] <= GRAD_RTOL
                and e["bias_share"] <= PRE_BN_BIAS_SHARE):
            failed.append(key)
    print(f"two-card halo conv [{card}] (2, 512, 256) frames over 2 ranks, k = 5: "
          f"{res['halo_conv_err']:.3e} of the max (limit {CONV_RTOL})", flush=True)
    check(len(res) == 4 and not failed, f"two-card VAE steps differ from one process: {failed}")
    check(res["halo_conv_err"] <= CONV_RTOL, f"two-card halo conv differs: {res['halo_conv_err']}")



def two_card_cli(card, dev, work):
    """Phase 15 (iv): ``train`` through torchrun on two cards (NCCL, dp 2)
    against one process, from the same seed on a phase 8-style corpus:
    rank 0 alone logs and writes the checkpoints, and each epoch's mean
    loss is the one process's within CLI_LOSS_RTOL."""
    from dvc_tpu_torch.config import AudioConfig
    mels = os.path.join(work, "mels")
    make_corpus(mels, dev, AudioConfig(), 16, lambda ui: 1.2 + 0.05 * ui)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")])}
    train = ["-m", "dvc_tpu_torch.cli.run", "train", "--dataset_fp", mels, "--epochs", "2",
             "--report-interval", "2", "--batch-size", str(TRAIN_BATCH), "--compute-dtype",
             "float32", "--device", "cuda"]
    losses, secs = {}, {}
    for name, launch in (("one", []), ("two", ["-m", "torch.distributed.run", "--standalone",
                                               "--nproc_per_node=2"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *launch, *train, "--log_dir",
                              os.path.join(work, name)], env=env, capture_output=True,
                             text=True, timeout=PARALLEL_TIMEOUT_S)
        secs[name] = time.perf_counter() - t0
        check(out.returncode == 0, f"train ({name}) failed: {out.stdout[-2000:]}"
                                   f"{out.stderr[-2000:]}")
        losses[name] = [float(ln.split("loss ")[1].split()[0]) for ln in out.stdout.splitlines()
                        if ln.startswith("====> Epoch")]
    ck = os.path.join(work, "two", "checkpoints")
    err = max(abs(a - b) / abs(a) for a, b in zip(losses["one"], losses["two"]))
    print(f"two-card train through torchrun [{card}] 2 epochs at batch {TRAIN_BATCH}, float32: "
          f"epoch losses {losses['two']} against one process's {losses['one']}, rel err "
          f"{err:.3e} (limit {CLI_LOSS_RTOL}); {secs['two']:.1f} s against {secs['one']:.1f} s "
          f"(process start included); checkpoints {sorted(os.listdir(ck))}", flush=True)
    check(len(losses["one"]) == len(losses["two"]) == 2, f"epoch lines: {losses}")
    check(err <= CLI_LOSS_RTOL, f"torchrun train's losses differ from one process's: {err}")
    check(sorted(os.listdir(ck)) == [f"DisentangledVAE_VCTK_2{s}"
                                     for s in (".msgpack", ".opt.pth", ".pth")],
          f"torchrun train's checkpoints: {os.listdir(ck)}")


def parallel_phase(card, dev):
    """Phase 15: the mesh layer (dvc_tpu_torch/parallel, torch.distributed;
    no hand kernel: NCCL's collectives are GSPMD's)."""
    import datetime
    import torch.distributed as dist
    from dvc_tpu_torch.parallel.multihost import initialize_distributed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as work:
        multi = initialize_distributed(f"file://{work}/store", 1, 0, device=dev,
                                       timeout=datetime.timedelta(seconds=300))
        check(not multi and dist.get_backend() == "nccl", "no one-rank NCCL group")
        try:
            timing = mesh_step_against_plain(card, dev)
            sharded_lstm_on_card(card, dev)
            ge2e_mesh_step(card, dev)
            long_context_mesh(card, dev)
        finally:
            dist.destroy_process_group()
        if torch.cuda.device_count() >= 2:
            os.makedirs(os.path.join(work, "two"))
            two_card_check(card, os.path.join(work, "two"))
            two_card_cli(card, dev, os.path.join(work, "cli"))
        else:
            print(f"two-card check [{card}]: not run, {torch.cuda.device_count()} card visible",
                  flush=True)
    return timing


D4C_VOICED_ATOL = 2e-4   # phase 16 (iii): d4c_batch card against CPU on voiced frames
                         # (1.3e-6 on the first run), test_d4c_tpu.py:121's limit; the gate
                         # that tests/test_torch_port_d4c.py holds the port to against
                         # dvc_tpu is 0.01, where two FFT implementations differ in the group
                         # delay's spectral valleys; unvoiced and padded frames 1 within
D4C_ONE_ATOL = 1e-6      # D4C_ONE_ATOL
D4C_CPU_EVERY = 4        # phase 16 (iii): the CPU's D4C on every 4th wav (12 of 48: all 48
                         # took 28.2 s of the phase on the card's host)
RESUME_LOSS_RTOL = 1e-6  # phase 16 (ii): the epoch after an orbax resume against the epoch
                         # after a msgpack resume of the same state (cuDNN deterministic)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def flat_tree(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(flat_tree(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): np.asarray(v)})
    return out


def trees_equal(a, b) -> bool:
    fa, fb = flat_tree(a), flat_tree(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]) for k in fa)


def orbax_d4c_phase(card, dev, mel8, recipe):
    """Phase 16: dvc_tpu's orbax checkpoints (utils/orbax.py over
    utils/ocdbt.py and native/dvc_zstd.cpp) at full width on the card, and
    the device D4C (ops/d4c.py).  No hand kernel: nothing here reaches
    pl.pallas_call in dvc_tpu."""
    import glob
    from dvc_tpu_torch.config import Config, TrainConfig
    from dvc_tpu_torch.data.dataset import PairedMelDataset
    from dvc_tpu_torch.ops.audio import resample_poly
    from dvc_tpu_torch.ops.d4c import d4c_batch
    from dvc_tpu_torch.ops.harvest import harvest_batch
    from dvc_tpu_torch.ops.world import world_decompose_batch
    from dvc_tpu_torch.train import checkpoint as ckpt
    from dvc_tpu_torch.train.trainer import Trainer
    from dvc_tpu_torch.utils.orbax import read_orbax_state, write_orbax_state
    from dvc_tpu_torch.utils.wavio import read_wav
    run = ckpt.RUN_NAME
    cfg = Config(train=TrainConfig(batch_size=TRAIN_BATCH, seed=SEED, compute_dtype="float32",
                                   checkpoint_format="orbax"))

    def dataset():
        return PairedMelDataset(mel8, samples_length=cfg.vae.frames, seed=SEED)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax_") as work:
        # (i) the trainer at full width, batch 8, a few steps; its orbax save
        # (Trainer.save, as train --checkpoint-format orbax saves) read back
        # equals its state bit for bit
        ck = os.path.join(work, "orbax")
        tr = Trainer(cfg, checkpoints_path=ck, device=dev)
        hist = tr.run_training(dataset(), 1, report_interval=2, logging_func=lambda m: None)
        t0 = time.perf_counter()
        tr.save(1)
        save_s = time.perf_counter() - t0
        path = os.path.join(ck, f"{run}_1.orbax")
        check(os.path.isdir(path) and math.isfinite(hist[0]["total"]), f"no store: {hist}")
        t0 = time.perf_counter()
        want = ckpt.train_state_tree(tr.model, tr.optimizer, tr.step)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_orbax_state(os.path.join(work, "timed.orbax"), want)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = read_orbax_state(path)
        read_s = time.perf_counter() - t0
        n_bytes = dir_bytes(path)
        n_params = sum(p.numel() for p in tr.model.parameters())
        equal = trees_equal(got, want)
        print(f"orbax save/load [{card}] full-width TrainState ({n_params} parameters, step "
              f"{tr.step}): {n_bytes} bytes on disk; Trainer.save {save_s:.3f} s (the .orbax, "
              f"then the .opt.pth/.pth pair), of it the tree off the card {tree_s:.3f} s and "
              f"the orbax write {write_s:.3f} s; read {read_s:.3f} s (host disk, warm); read "
              f"back bit-equal to the trainer's state: {equal}", flush=True)
        check(equal, "the orbax store read back differs from the trainer's state")

        # (ii) resume: the epoch after an orbax resume against the epoch after a
        # msgpack resume of the same state (the .pth pairs removed, so each
        # format's own tree is what is read)
        mk = os.path.join(work, "msgpack")
        ckpt.save_checkpoint(mk, run, 1, tr.model, tr.optimizer, tr.step, fmt="msgpack")
        for d in (ck, mk):
            for f in glob.glob(os.path.join(d, f"{run}_1*.pth")):
                os.remove(f)
        state = {n: v.detach().cpu() for n, v in tr.model.state_dict().items()}
        del tr
        losses = {}
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for fmt, d in (("orbax", ck), ("msgpack", mk)):
                c = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_format=fmt))
                again = Trainer(c, checkpoints_path=d, device=dev)
                check(again.load_last() == 2, f"{fmt} resume is not at epoch 2")
                loaded = again.model.state_dict()
                check(all(n.endswith("num_batches_tracked") or torch.equal(
                    loaded[n].cpu(), state[n]) for n in state), f"{fmt} resume differs")
                losses[fmt] = [h["total"] for h in again.run_training(
                    dataset(), 1, report_interval=3, logging_func=lambda m: None)]
                del again
        finally:
            torch.backends.cudnn.deterministic = prev
        err = abs(losses["orbax"][0] - losses["msgpack"][0]) / abs(losses["msgpack"][0])
        print(f"orbax resume [{card}]: epoch 2 loss {losses['orbax']} against a msgpack "
              f"resume's {losses['msgpack']}, rel err {err:.3e} (limit {RESUME_LOSS_RTOL}); "
              f"both resumed the trainer's weights bit for bit", flush=True)
        check(err <= RESUME_LOSS_RTOL, f"orbax resume's losses differ: {losses}")
        torch.cuda.empty_cache()

    # (iii) d4c_batch on the recipe's 48 wavs (resampled to 16 kHz), card
    # against CPU; world_decompose_batch(keep_sp_ap=True) once
    fs = 16000
    wavs = []
    wav16 = os.path.join(recipe, "vctk", "VCTK-Corpus", "wav16")
    for f in sorted(glob.glob(os.path.join(wav16, "*", "*.wav"))):
        w, sr = read_wav(f)
        wavs.append(resample_poly(torch.from_numpy(w).to(dev), sr, fs).cpu().numpy())
    check(len(wavs) == 48, f"recipe wavs: {len(wavs)}")
    n = max(len(w) for w in wavs)
    batch = np.zeros((len(wavs), n), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    batch_d = torch.from_numpy(batch).to(dev)
    frames = n // 80 + 1
    f0 = harvest_batch(batch_d, [len(w) for w in wavs], fs, 5.0)
    f0 = torch.nn.functional.pad(f0, (0, max(0, frames - f0.shape[-1])))[:, :frames]
    d4c_batch(batch_d[:2], f0[:2], fs, device=dev)  # first call: cuFFT plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ap = d4c_batch(batch_d, f0, fs, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    rows = slice(0, None, D4C_CPU_EVERY)
    t0 = time.perf_counter()
    ap_cpu = d4c_batch(batch[rows], f0[rows].cpu(), fs, device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    ap, f0h = ap.cpu().numpy(), f0.cpu().numpy()
    voiced = f0h[rows] >= 47.0
    err = float(np.abs(ap[rows] - ap_cpu)[voiced].max())
    one = float(np.abs(ap[f0h < 47.0] - 1.0).max())
    audio_s = sum(len(w) for w in wavs) / fs
    print(f"d4c_batch [{card}] {len(wavs)} wavs, {audio_s:.1f} s of audio padded to "
          f"({len(wavs)}, {n}), {frames} frames each: {card_s:.3f} s on the card "
          f"({audio_s / card_s:.1f} s of audio a second); every {D4C_CPU_EVERY}th wav on the "
          f"CPU in {cpu_s:.2f} s, card against CPU on its voiced frames {err:.3e} (limit "
          f"{D4C_VOICED_ATOL}); unvoiced and padded frames within {one:.1e} of 1 (limit "
          f"{D4C_ONE_ATOL})", flush=True)
    check(err <= D4C_VOICED_ATOL, f"card d4c differs from the CPU's: {err}")
    check(one <= D4C_ONE_ATOL, f"unvoiced frames are not fully aperiodic: {one}")
    t0 = time.perf_counter()
    res = world_decompose_batch(wavs[:8], fs, keep_sp_ap=True, device=dev)
    wd_s = time.perf_counter() - t0
    ok = all(sp is not None and ap_ is not None and sp.shape == ap_.shape == (len(f0_), 513)
             and np.isfinite(sp).all() and (ap_ >= 0.001).all() and (ap_ < 1.0).all()
             for f0_, _, sp, ap_, _ in res)
    print(f"world_decompose_batch(keep_sp_ap=True) [{card}] 8 wavs: {wd_s:.2f} s, sp and ap "
          f"of every frame, finite and in range: {ok}", flush=True)
    check(ok, "world_decompose_batch(keep_sp_ap=True) returned no sp/ap or out of range")
    return {"save_s": save_s, "read_s": read_s, "bytes": n_bytes,
            "d4c_audio_per_s": audio_s / card_s}


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
    from dvc_tpu_torch.serve import ConversionService, make_http_server
    from dvc_tpu_torch.utils.device import use_exact_float32
    from dvc_tpu_torch.utils.wavio import parse_wav, wav_bytes

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    use_exact_float32()
    card = card_line()
    print(f"card: {card}", flush=True)

    phase_t = [time.perf_counter()]

    def phase_done(n):
        phase_t.append(time.perf_counter())
        print(f"phase {n} seconds: {phase_t[-1] - phase_t[-2]:.1f}", flush=True)

    # 1. build ---------------------------------------------------------------
    from dvc_tpu_torch.native import _build as native_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kernels, engines = pool.submit(_build.build_all), pool.submit(native_build.build_all)
        secs, native_secs = kernels.result(), engines.result()
    print(f"build: {json.dumps(secs)}; native engines (g++): {json.dumps(native_secs)} "
          f"({time.perf_counter() - t0:.1f} s wall)", flush=True)

    phase_done(1)

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

    phase_done(2)

    # 3. the main path ------------------------------------------------------------
    acfg = AudioConfig()
    cfg = Config(vae=VAEConfig())
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    mel_dir = os.path.join(tmp.name, "mels")
    make_corpus(mel_dir, dev, acfg, 2, lambda ui: 1.0)

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
    port = free_port()
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

    phase_done(3)

    # 4. the kernel at the main path's shapes -----------------------------------
    shapes = max((s for s, _ in seen), key=len)
    b_main = len(shapes)
    f_main = -(-max(s[1] for s in shapes) // 32) * 32     # make_vocoder's frame bucket
    g = torch.Generator(device=dev).manual_seed(20)
    frames = torch.rand(b_main, f_main, vcfg.cin_channels, device=dev, generator=g)
    with torch.inference_mode():
        cond = det.upsample(frames).contiguous()
    # float32 first (the fine check), then bf16: the main path's weights,
    # whose numbers go into the report.  The closed-loop plain sampler runs
    # the first F32_MAIN_STEPS steps (its depth cut to keep the script's
    # time; the sampler is causal, so they are the full run's first steps),
    # and the kernels line times the kernel on the same steps; every step of
    # the bf16 kernel's full run is held to the plain function teacher-forced
    # on the kernel's own samples (wavenet_open_loop_plain with feedback).
    full_cond = cond
    head = full_cond[:, :F32_MAIN_STEPS].contiguous()
    for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        cond = head if dtype == torch.float32 else full_cond
        packed = ws.pack_wavenet_params(det, dtype, dev)
        checked, draws, _ = ws.wavenet_generate_checked(packed, cond, 0, True)
        check(bool((draws == checked[None]).all()), f"{dtype}: the blocks' draws disagree")
        kern, k_ms = events_ms(lambda: ws.wavenet_generate(packed, cond, 0, True))
        check(torch.equal(kern, checked), f"{dtype}: the timed call differs from the checked one")
        kern_h, kh_ms = events_ms(lambda: ws.wavenet_generate(packed, head, 0, True))
        check(torch.equal(kern_h, kern[:, :F32_MAIN_STEPS]),
              f"{dtype}: the kernel's first steps differ between the head and the full run")
        plain, p_ms = events_ms(lambda: ws.wavenet_generate_plain(packed, head, 0, True))
        err = (kern_h - plain).abs().max().item()
        forced, f_ms = events_ms(lambda: ws.wavenet_open_loop_plain(packed, cond, kern))
        f_err = (kern - forced).abs().max().item()
        b_ms, b_by = bound(packed, head)
        name = str(dtype).replace("torch.", "")
        print(f"kernel at main-path shapes [{card}] cond {tuple(cond.shape)} {name}: "
              f"{k_ms:.1f} ms ({k_ms * 1e3 / cond.shape[1]:.1f} us/sample-step); its first "
              f"{F32_MAIN_STEPS} steps: kernel {kh_ms:.1f} ms, plain {p_ms:.1f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}), max_abs_err {err:.3e} (atol {atol}); every step "
              f"against the plain function teacher-forced on the kernel's samples "
              f"({f_ms:.1f} ms): max_abs_err {f_err:.3e} (atol {atol}); trajectory std "
              f"{plain.std().item():.4f}", flush=True)
        check(math.isfinite(err) and err <= atol, f"main-shape {name} kernel vs plain {err}")
        check(math.isfinite(f_err) and f_err <= atol,
              f"main-shape {name} kernel vs teacher-forced plain {f_err}")
        check(plain.std().item() > MAIN_STD, "doctored trajectory does not move")
        del forced
    tmp.cleanup()
    k1 = {"launches": launches, "max_abs_err": err, "ms": kh_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bound_by": b_by, "steps": F32_MAIN_STEPS,
          "full_steps": full_cond.shape[1], "full_ms": k_ms,
          "forced_max_abs_err": f_err}  # bf16: the main path's weights

    phase_done(4)

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

    phase_done(5)

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
    # held here to wavenet_generate_plain on the first pack.  That plain
    # sampler runs the first F32_MAIN_STEPS steps (its depth cut to keep the
    # script's time; the sampler is causal, so they are the full run's first
    # steps), and the kernel's line times the kernel on the same cond.
    _, q8_ms = events_ms(lambda: ws.wavenet_generate(q8, cond, 0, True))
    nofb = copy.deepcopy(det)
    with torch.no_grad():
        nofb.first_conv.weight.zero_()
    f8 = ws.pack_wavenet_params(nofb, torch.float32, dev, quantize=True)
    kern8, _ = events_ms(lambda: ws.wavenet_generate(f8, cond, 0, True))
    _, k8_full_ms = events_ms(lambda: ws.wavenet_generate(f8, cond, 0, True))
    cond_n = cond[:, :F32_MAIN_STEPS].contiguous()
    _, k8_ms = events_ms(lambda: ws.wavenet_generate(f8, cond_n, 0, True))
    plain8, p8_ms = events_ms(lambda: ws.wavenet_generate_plain(f8, cond_n, 0, True))
    open8, o8_ms = events_ms(lambda: ws.wavenet_open_loop_plain(f8, cond))
    ol_max = (open8[:, :F32_MAIN_STEPS] - plain8).abs().max().item()
    ol_rms = (open8[:, :F32_MAIN_STEPS] - plain8).pow(2).mean().sqrt().item()
    b8_ms, b8_by = bound(f8, cond_n)
    print(f"kernel at main-path shapes [{card}] cond {tuple(cond.shape)} int8, final1 float32, "
          f"no feedback: {k8_full_ms:.1f} ms ({k8_full_ms * 1e3 / cond.shape[1]:.1f} "
          f"us/sample-step; generate's bf16-final1 pack {q8_ms:.1f} ms); its first "
          f"{F32_MAIN_STEPS} steps {tuple(cond_n.shape)}: kernel {k8_ms:.1f} ms, plain "
          f"{p8_ms:.1f} ms, bound {b8_ms:.3f} ms ({b8_by}); the open-loop plain version over "
          f"all steps ({o8_ms:.1f} ms) against the plain version on those: max_abs_err "
          f"{ol_max:.3e}, rms err {ol_rms:.3e} (the kernel's limits, atol {INT8_FULL_ATOL}, "
          f"rms {INT8_FULL_RMS})", flush=True)
    check(math.isfinite(ol_max) and ol_max <= INT8_FULL_ATOL and ol_rms <= INT8_FULL_RMS,
          f"the open-loop plain version disagrees with the plain version: {ol_max} "
          f"(rms {ol_rms})")

    def held(name, kern, ref, atol, rms, bad):
        """kern against ref within atol (max) and rms, and every corrupted
        pack of bad {what: (pack, whether it must fail)} rejected, over
        ref's steps (the first of cond's); returns the max error."""
        steps = ref.shape[1]

        def errs(out):
            d = out[:, :steps] - ref
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
            e = errs(ws.wavenet_generate(pack, cond[:, :steps].contiguous(), 0, True))
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
          "bound_ms": b8_ms, "bound_by": b8_by, "steps": F32_MAIN_STEPS,
          "full_steps": cond.shape[1], "full_ms": k8_full_ms}

    phase_done(6)

    # 7. the tools/ probes ------------------------------------------------------
    pr = probes(card, dev)
    phase_done(7)

    # 8. the VAE training path; 9. the serving defaults ---------------------------
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    mel8, run8, plain8 = train_phase(card, dev, work.name)
    phase_done(8)
    serve_phase(card, dev, mel8, run8)
    phase_done(9)

    # 10. the verify recipe through the CLI; 11. the vocoders trained and served
    recipe = tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_")
    recipe_phase(card, dev, recipe.name)
    phase_done(10)
    vocoder_phase(card, dev, recipe.name, mel8, run8, b_main, f_main)
    phase_done(11)

    # 12. the mel VAE's remaining train and convert options, on phase 10's run
    latent_phase(card, dev, recipe.name, plain8)
    phase_done(12)

    # 13. the GE2E speaker encoder and the AutoVC baseline
    speaker_phase(card, dev, recipe.name)
    phase_done(13)

    # 14. the WORLD route, on phase 10's corpus
    world_phase(card, dev, recipe.name)
    phase_done(14)

    # 15. the mesh layer: a one-rank NCCL group, and two cards where there are
    parallel = parallel_phase(card, dev)
    print(f"mesh step against phase 8's plain step [{card}]: {parallel['mesh_ms']:.2f} ms "
          f"(phase 8: {plain8['ms']:.2f} ms)", flush=True)
    phase_done(15)

    # 16. orbax checkpoints and the device D4C, on phases 8 and 10's corpora
    orbax_d4c_phase(card, dev, mel8, recipe.name)
    recipe.cleanup()
    work.cleanup()
    phase_done(16)

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
        {**probe_entry("probe_streamed", "probe_body.cu", "tools/bench_body.py:165", "streamed",
                       None), "graph_us": pr[("streamed", None)]["graph_us"]},
        probe_entry("probe_body2", "probe_body.cu", "tools/bench_body2.py:123", "body2", 4),
    ]}
    print(json.dumps(report), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of phase 15's two-card ranks
        sys.exit(parallel_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
