"""Spans on the profiler's clock, and numerics debugging.

The program records a span at each layer boundary of its serving and
training paths, and only while a ``torch.profiler`` records: outside one,
``span()`` is one read of the profiler's process-wide flag and returns a
shared no-op context.  While one records, a span

  * opens a ``torch.profiler.record_function`` range of its name, so the
    profiler's own trace carries the same names;
  * appends a record to a bounded in-memory buffer (``recorded()``):
    ``name``, ``t0`` and ``t1`` from ``time.time_ns()`` (the epoch clock that
    the profiler's exported ``baseTimeNanoseconds`` + ``ts`` also reads),
    ``tid`` (the native thread id) and ``ident`` (the low word of the
    pthread id; profiler builds name a launching thread by either),
    ``id``, ``parent`` (the id of the span open on the same thread, or
    None) and the span's attributes.

``interval()`` records a span that is not lexically scoped (a request's
wait in a queue) under the same gate.  ``span()`` yields its record while
it records and None otherwise, so code inside it can add values known only
there, and can do work for the span only while it records.

debug_nans() is the reference's always-on
``torch.autograd.set_detect_anomaly`` (model/disentangled_vae.py:313),
scoped and behind a switch.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_RECORDS: collections.deque = collections.deque(maxlen=50_000)
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the records of the spans open on this thread
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch.profiler records now: the flag ``record_function``'s
    own fast path reads, True in every thread during a profiler's active
    steps.  False where a torch build lacks the flag (its test fails
    there)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _stack() -> list[dict]:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _record(name: str, attrs: dict) -> dict:
    stack = _stack()
    return {"name": name, "id": next(_IDS), "parent": stack[-1]["id"] if stack else None,
            "tid": threading.get_native_id(), "ident": threading.get_ident() & 0xFFFFFFFF,
            **attrs}


class _Span:
    __slots__ = ("_rec", "_range")

    def __init__(self, name: str, attrs: dict):
        self._rec = _record(name, attrs)
        self._range = torch.profiler.record_function(name)

    def __enter__(self) -> dict:
        rec = self._rec
        rec["t0"] = time.time_ns()
        self._range.__enter__()
        _stack().append(rec)
        return rec

    def __exit__(self, *exc) -> None:
        _OPEN.stack.pop()
        self._range.__exit__(*exc)
        self._rec["t1"] = time.time_ns()
        _RECORDS.append(self._rec)


def span(name: str, **attrs):
    """A context manager that records the enclosed code as a span ``name``
    with ``attrs`` while a profiler records, and does nothing otherwise."""
    if not recording():
        return _OFF
    return _Span(name, attrs)


def interval(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Record a span ``name`` from ``t0_ns`` to ``t1_ns`` (``time.time_ns()``
    readings) while a profiler records; its parent is the span open on the
    calling thread."""
    if recording():
        rec = _record(name, attrs)
        rec["t0"], rec["t1"] = t0_ns, t1_ns
        _RECORDS.append(rec)


def recorded() -> list[dict]:
    """A copy of the recorded spans, oldest first (the buffer keeps the
    newest 50,000)."""
    return list(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped anomaly detection: a backward that produces NaN raises and
    names the forward op (the reference's set_detect_anomaly, scoped)."""
    with torch.autograd.set_detect_anomaly(enable):
        yield
