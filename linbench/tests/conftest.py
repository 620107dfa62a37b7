"""The benchmark's CPU tests: ``python3 -m pytest linbench/tests -q``.
Tests marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card; skips without one")
