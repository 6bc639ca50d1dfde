"""Shared set-up of the benchmark's tests: the repository's root and
``src`` on the path, and the ``chip`` marker for tests that need a CUDA
card.

Run the tests that need the card on it with
``python3 -m pytest -q -m chip bench/tests``.
"""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def _one_host_thread():
    """Each test on one host thread: test runs put several workers on one
    machine, and their threads would crowd each other out."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
