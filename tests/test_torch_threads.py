"""A fixture that runs a test module's torch CPU work on one thread.

pytest-xdist runs several test files at once, one process each, and
torch's CPU kernels start an OpenMP team as wide as the machine in every
process: with more threads than cores the teams spin against each other
and small-shape runs slow down many times over.  The port's parity tests
use small shapes, so one thread costs them nothing alone.  Import the
fixture into a test module to apply it there::

    from test_torch_threads import one_torch_thread  # noqa: F401
"""
from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fixture_pins_one_thread():
    assert torch.get_num_threads() == 1
