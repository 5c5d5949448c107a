"""pytest settings of the benchmark's own tests (``pytest portbench``).

Tests that need the CUDA card carry the ``card`` marker and decide inside
the test whether a card is there, so that every worker collects the same
tests."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card; skips without one")
