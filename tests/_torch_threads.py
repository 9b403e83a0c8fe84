"""One torch intra-op thread for the port's CPU tests.

The suite's xdist workers share the machine's cores, and torch's default
pool of one thread per core in each of them oversubscribes the cores: a
test of many small tensor ops then waits on its threads far longer than
it computes (one implicit Schur product at 256 points took 434 ms with 8
threads and 12.8 ms with 1 beside five other workers, 1.0 ms and 0.9 ms on
an idle machine).  One thread also makes an in-process run sum in the
order of the ranks that `multihost.run_ranks` starts (one thread each).
A port test module takes the fixture by importing it:

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the module, then as before."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
