"""One intra-op thread for the port's CPU tests.

The suite runs several worker processes at once (pytest-xdist), and each
PyTorch CPU op starts a team of as many threads as the machine has cores.
The port runs thousands of small ops, whose thread teams then wait on
each other across the workers: three of these test files run side by
side took 450-510 s each with the default thread count and 100-128 s
with one thread (8-core machine).  A test module that imports
:func:`one_torch_thread` runs its torch ops on one thread and restores
the count after.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
