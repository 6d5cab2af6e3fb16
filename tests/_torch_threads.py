"""One intra-op thread for the port's CPU tests.

The port's tests compute on small tensors.  At torch's default of one
intra-op thread a core, each xdist worker running them spreads over
every core of the machine that the suite's workers share, and slows
the wall-clock-bounded tests running beside them.  Importing the
fixture into a test module pins torch to one thread while that module
runs and restores the count after it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
