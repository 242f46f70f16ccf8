"""An autouse fixture for the port's test files: each test runs the
port's plain torch on one intra-op thread, restored after the test.

The port's plain versions run many small ops (a scan step, a claim loop);
with several test workers sharing the cores, idle intra-op pool threads
made such tests tens to a hundred times slower than alone. A test file
takes the fixture with `from torch_one_thread import one_torch_thread`."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
