"""`one_torch_thread`: torch on one CPU thread for the length of a test.

The suite runs several pytest workers on the machine's cores, and torch's
thread pool in each of them, spinning over small ops, multiplies a test's
time many times over (a 0.3 s CLI run took 20-30 s under six workers).
The port's CPU test modules apply it to every test with
`pytestmark = pytest.mark.usefixtures("one_torch_thread")`. This module
imports no JAX, so the modules that need none can take it too.
"""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
