"""One torch intra-op thread for each of the port's CPU test modules.

The repo's Tier-1 command runs six pytest workers (``-n 6``).  Each
worker's torch starts one intra-op thread per core, so the workers' thread
pools oversubscribe the cores, and the port's tests, which run many small
torch ops, wait on descheduled threads at every parallel region: on an
eight-core CPU a MiniF2F parity case took 59 s with six copies running at
once and 5.5 s with one thread each (3.2 s alone).  A port test module
imports this fixture; it caps torch at one thread for the module and
restores the count after it, so the next module a worker runs is
untouched.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
