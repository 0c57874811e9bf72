"""The port's test files run in one torch thread each: the suite runs its
files side by side on one host (and the spawned ranks take one thread
each), so torch's default thread pool per file would contend for its cores.
A file opts in with ``from _torch_threads import one_torch_thread``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the importing file's tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
