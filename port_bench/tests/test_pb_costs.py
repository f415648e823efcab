"""The yardstick's counts against hand counts."""

import pytest

from port_bench import common
from port_bench.costs import PEAK_FLOPS, vae, vocoder

MEL = common.load_json(common.BENCH_DIR / "configs" / "dvae-mel80-wavenet.json")
MCC = common.load_json(common.BENCH_DIR / "configs" / "dvae-mcc36.json")


def test_sampler_operations_a_sample_and_row():
    # 24 x (512 x (3 x 512 + 80) + 768 x 256) + 256 x 256 + 30 x 256
    assert vocoder.sampler_macs(MEL["vocoder"]) == 24_649_216
    assert 2 * vocoder.sampler_macs(MEL["vocoder"]) == 49_298_432


def test_upsampler_and_call_cost():
    voc = MEL["vocoder"]
    # four stages of ConvTranspose2d (3, 8) over 80 bins: 80 x 3 x 8 x (1 + 4 + 16 + 64)
    assert vocoder.upsample_macs(voc, 1) == 80 * 24 * 85
    flops, nbytes = vocoder.call_cost(voc, 8, 384)
    assert flops == 2.0 * 8 * (384 * 256 * 24_649_216 + 384 * 80 * 24 * 85)
    assert nbytes > 49e6  # the bf16 weights are read at least once
    assert vocoder.least_seconds(voc, 8, 384) == pytest.approx(flops / PEAK_FLOPS["bfloat16"])


def test_vae_frame_count_by_hand():
    v = MEL["vae"]
    enc = 80 * 512 * 5 + 2 * 512 * 512 * 5 + 4 * 64 * (512 + 64) * 2 + 4 * 64 * (128 + 64) * 2
    dec = 4 * 512 * (128 + 512) + 3 * 512 * 512 * 5 + 4 * 1024 * (512 + 1024) \
        + 4 * 1024 * 2048 + 1024 * 80
    post = 2 * 80 * 512 * 5 + 3 * 512 * 512 * 5
    assert vae.frame_macs(v) == enc + dec + post == 27_566_080
    assert vae.sequence_macs(v) == 8192 * 2048 * 2 + 2048 * 8 + 2048 * 56 + 32 * 2048


def test_pair_step_against_the_82_ms_float32_bound():
    assert vae.train_step_bound_s(MEL["vae"], 256) * 1e3 == pytest.approx(82.4, abs=0.1)
    # the MCC step has twice the frames and a 16,384-wide flat linear
    assert vae.train_step_bound_s(MCC["vae"], 256) * 1e3 == pytest.approx(162.6, abs=0.1)
