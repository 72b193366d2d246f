"""The benchmark's own CPU tests: ``python -m pytest gpubench/tests`` from
the root of the checkout. Tests marked ``cuda`` need an NVIDIA GPU and skip
where none is visible (decided inside the test)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where none is visible")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch at one thread a test: several test workers would otherwise
    oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
