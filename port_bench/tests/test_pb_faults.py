"""A run with its timed path broken underneath must come out not correct.

Each test skips the harness's look for a chip and drives the rest of a run
(set-up, window, judge) at a tiny width on the CPU, with one fault planted
where the program produces its answer, and holds the numbers to the cell's
own limits: a served answer altered where it is made (the serving cells);
a step that returns its state unchanged, half of the batch left out with
the mean taken over the rest, and the dataset's cache serving altered
data to the window (the training cells).  One card holds a
cell, so no exchange between chips can be left out."""

import pytest

from port_bench.drivers import http_convert, train_epochs
from port_bench.tests import tiny


@pytest.mark.parametrize("clients", [1, 2])
def test_altered_answer_is_not_correct(clients):
    out = http_convert.run(tiny.serve_ctx(variant="altered", clients=clients))
    assert not all(c.ok for c in out.checks)


@pytest.mark.parametrize("fault", ["frozen", "halfbatch", "stalecache"])
@pytest.mark.parametrize("cell", ["train-mel80-b256", "train-mcc36-b256"])
def test_broken_step_is_not_correct(cell, fault):
    out = train_epochs.run(tiny.train_ctx(cell, variant=fault))
    assert not all(c.ok for c in out.checks)


def test_sound_runs_are_correct_under_the_same_limits():
    for ctx in (tiny.serve_ctx(), tiny.train_ctx()):
        run = http_convert.run if ctx.traffic["driver"] == "http_convert" else train_epochs.run
        assert all(c.ok for c in run(ctx).checks)
