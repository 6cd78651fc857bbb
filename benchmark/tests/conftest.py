"""The benchmark's own tests: CPU tests of its reference, arithmetic,
loading and judge, and `gpu` tests that run a cell on a CUDA card (they
skip, deciding inside the test, where there is none).

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu     # on a machine with a card
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on a card with -m gpu)")
