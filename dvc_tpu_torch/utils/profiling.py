"""Tracing, step timing and numerics debugging (port of
dvc_tpu/utils/profiling.py).

The reference has two wall-time decorators and an always-on
``torch.autograd.set_detect_anomaly`` (model/disentangled_vae.py:313).
As in dvc_tpu:

  * trace(): a ``torch.profiler`` scope (CPU and, where there is one, the
    card) whose trace is written under ``logdir`` for TensorBoard;
  * StepTimer: rolling per-step wall-time statistics, the same window and
    summary as dvc_tpu's;
  * debug_nans(): scoped anomaly detection, the reference's sanitizer
    behind a switch.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed code; the trace lands in ``logdir`` as a
    TensorBoard profile (``*.pt.trace.json``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as p:
        yield p


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped anomaly detection: a backward that produces NaN raises and
    names the forward op (the reference's set_detect_anomaly, scoped)."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


class StepTimer:
    """Rolling per-step wall-time statistics over the last ``window`` steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_ms(self) -> float:
        return 1000.0 * float(np.mean(self._times)) if self._times else 0.0

    @property
    def std_ms(self) -> float:
        return 1000.0 * float(np.std(self._times)) if self._times else 0.0

    def summary(self) -> str:
        return f"{self.mean_ms:.1f} ± {self.std_ms:.1f} ms/step"
