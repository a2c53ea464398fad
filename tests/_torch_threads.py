"""The one torch thread rule for the port's tests: every
tests/test_torch_*.py module takes it with

    from _torch_threads import one_thread  # noqa: F401

and pytest runs the module under the imported autouse fixture."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # the suite runs several pytest-xdist workers on shared cores; the
    # plain path's many small ops spin-wait at more threads than a worker
    # has cores, and run several times faster on one
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
