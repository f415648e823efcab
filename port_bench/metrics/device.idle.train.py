"""Idle share of the device over the training window (metrics/_idle.py)."""

from port_bench.metrics._idle import idle_percent as read  # noqa: F401
