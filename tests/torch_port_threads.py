"""One torch thread in each port test module.

The suite runs in several worker processes at once, and torch's default of
one thread per core in each of them oversubscribes the CPU: the port's test
files took 3x longer under six workers. Each ``test_torch_port_*`` module that
runs torch imports the fixture, which makes it autouse there:

    from torch_port_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
