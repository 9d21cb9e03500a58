"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that need a card (they decide inside the test whether one is
there).  Run from the repository root: ``python -m pytest slam_bench/tests``."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
