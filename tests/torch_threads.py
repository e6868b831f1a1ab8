"""The torch intra-op thread count of the port's CPU test files.

A test run gives each of its six workers whole files, and PyTorch starts
one intra-op thread per core in each: six workers on eight cores then run
up to 48 threads that wait on each other. Each of the port's test modules
imports ``torch_threads`` (an autouse fixture of module scope), which caps
the count while its tests run and puts it back after, so that the JAX
suite's modules on the same worker keep theirs.
"""

from __future__ import annotations

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
