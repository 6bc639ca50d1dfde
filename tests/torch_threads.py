"""The port's test files' one-thread fixture: a file imports
``one_torch_thread`` and pytest applies it to that file's tests."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the importing module: its runs make
    many small ops, and under the suite's parallel workers torch's
    default of a thread a core oversubscribes the CPU (an FL parity run
    took 143 s with the default and 30 s with one thread, beside five
    busy processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
