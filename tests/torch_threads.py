"""One PyTorch intra-op thread for the port's tests.

The suite runs as several pytest-xdist workers on a few cores.  Left
alone, every worker that imports PyTorch sizes its OpenMP pool to the
whole machine, and the kernels' plain versions, which the port runs on
CPU tensors, then wait on pool threads the other workers have preempted:
a test that takes 0.3 s on one thread took 55 s that way on a loaded
8-core host.  Import the fixture into a test module to use it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
