"""A fixture for the port's test files: one torch thread while a module runs.

The port's CPU tests run small tensors through thousands of operations, in
test workers that share the machine's cores.  Each worker's torch pool would
take every core: a GP sampler test took 67 s with eight threads and 3.9 s
with one on an 8-core host.  Import ``one_torch_thread`` into a test module
(autouse, module scope); the thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
