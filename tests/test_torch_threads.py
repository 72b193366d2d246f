"""One torch CPU thread for the port's CPU tests: ``one_torch_thread`` is a
module-scoped autouse fixture that the other ``tests/test_torch_*.py``
files import.

The suite runs in several pytest-xdist workers on the same cores, and each
worker's torch would start an OpenMP thread per core. Oversubscribed that
way, the spinning threads slow the port's many small CPU ops (the plain
versions of the kernels over tiny models) by an order of magnitude or
more, while those ops gain nothing from intra-op threads.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
