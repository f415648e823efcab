"""Load drivers, one per traffic kind: ``drivers/<driver>.py`` exposes
``run(ctx) -> common.Outcome``; a traffic mix names its driver."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Context:
    """What a driver is given: the cell's files, the run's arguments, the
    device, and the clock reading at process start (set-up starts there).
    ``variant`` is None for a benchmark run; the calibration and the tests
    set it to "control" (the next lower precision) or a fault name."""

    config: dict
    traffic: dict
    settings: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    variant: str | None = None
    notes: dict = field(default_factory=dict)
