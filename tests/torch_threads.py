"""One torch thread pool per pytest-xdist worker, sized to its share of the
machine.

Imported by the port's tests (tests/test_torch_*.py).  torch sizes its
intra-op pool to every core by default, so six xdist workers on eight
cores run six pools of eight threads each, whose spinning threads starve
one another: a test that takes 3.5 s alone took 235 s inside the suite,
and under five loaded torch processes one resume test took 135.3 s with
the default pool and 11.7 s with one thread on an 8-core host.  Under
xdist each worker gets ``cores // workers`` threads (at least one); a
run without xdist keeps torch's default.  Every worker collects every
test file, so the first import sets the pool for the whole worker.
"""

import os

import torch


def worker_threads() -> int | None:
    """The torch threads of one xdist worker, or None outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 1:
        return None
    return max(1, len(os.sched_getaffinity(0)) // workers)


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())
