"""Tests of the benchmark harness.  Run: ``python -m pytest port_bench/tests``.
Tests marked ``card`` need a CUDA device; each decides inside the test and
skips without one.  ``python -m pytest port_bench/tests -m card`` on the
chip runs them."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
