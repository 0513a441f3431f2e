"""One intra-op thread for the port's CPU tests of the DS/DC stack.

The suite runs its files in parallel worker processes; torch's default of
one OpenMP thread per core in each of them oversubscribes the host's cores,
and the plain NMS and ROIAlign, loops of small ops, slow down the most (the
DS/DC provider tests took 13.7 s on one thread alone and 460 s beside the
other workers at the default). A test module imports the fixture to use it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
