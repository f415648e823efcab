"""The benchmark's own tests: ``python -m pytest port_bench/tests -q`` from
the checkout's root (the repository's test run does not collect them).
Tests marked ``card`` need a CUDA card and skip inside their body without
one; on the card: ``python -m pytest port_bench/tests -q -m card``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
