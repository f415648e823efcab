"""The control, the next lower precision in the program's place, must come
out not correct.

On the CPU, at a tiny width, the serving judge must separate the control
(the program's int8 sampler path, where the CPU path serves float32
weights) from sound runs of the same seeds by at least three times.  On the
card (marked ``card``), at the cells' own sizes, the control must fail the
cells' limits: the serving cells' int8 sampler path with TF32 in the VAE,
the training cells' reference in TF32.  TF32 exists only on the card."""

import pytest
import torch

from port_bench import common
from port_bench.drivers import Context, http_convert, train_epochs
from port_bench.tests import tiny


def values(out):
    return {c.name: c.value for c in out.checks}


def test_serving_judge_separates_the_control_on_the_cpu():
    seed = 2 ** 31 + 21
    sound = values(http_convert.run(tiny.serve_ctx(seed=seed)))
    ctl = values(http_convert.run(tiny.serve_ctx(seed=seed, variant="control")))
    assert ctl["draw_ratio"] >= 3 * sound["draw_ratio"]


@pytest.mark.card
@pytest.mark.parametrize("cell,seconds", [("serve-wavenet-c1", 1.0),
                                          ("train-mel80-b256", 0.0), ("train-mcc36-b256", 0.0)])
def test_control_fails_at_the_cells_size(cell, seconds):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    c = common.load_cell(cell)
    driver = http_convert if c.traffic["driver"] == "http_convert" else train_epochs
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = Context(config=c.config, traffic=c.traffic, settings=c.settings, seed=seed,
                      seconds=seconds, trace=False, device="cuda:0",
                      t_start=time.perf_counter(), variant="control")
        assert not all(x.ok for x in driver.run(ctx).checks), (cell, seed)
