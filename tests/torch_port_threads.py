"""One torch thread for each module of the port's CPU tests.

The suite runs in several worker processes on a shared machine; torch's
default intra-op pool (one thread a core in every worker) oversubscribes
the cores, and the port's small CPU tensors then spend most of their time
waiting for descheduled pool threads.  Each port test module imports this
autouse fixture, which runs the module on one torch thread and restores the
pool after it; what the tests compute and compare is unchanged.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
