"""One intra-op thread for the port's CPU test modules.

The reduced models' torch ops are small: one thread runs them as fast as
eight, and a test run with several workers on one machine (the driver's
``-n 6``) no longer oversubscribes the cores with each worker's eight
threads, which made these modules several times slower.  A module applies
it to all of its tests by importing the fixture:

    from _torch_threads import one_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
