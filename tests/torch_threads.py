"""One torch intra-op thread for the port's CPU tests.

The suite runs its files in parallel worker processes (pytest-xdist) on
shared cores. With torch's default of one thread per core in every worker,
its OpenMP threads wait on cores that other workers hold, and the whole
suite ran 2.5 times slower. Each port test module imports `one_thread`."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
