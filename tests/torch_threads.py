"""The thread cap of the port's CPU tests.

The tier-1 test command runs six pytest workers on one machine; torch's
intra-op pool sizes itself to every core in each of them, and its
threads then contend with each other and with XLA's (the port's files
took ten times their one-process time in such a run). Each port test
module runs with ``TORCH_TEST_THREADS`` intra-op threads (its
module-scoped fixtures too), restored after it.
Import ``cap_torch_threads`` into a test module to apply it there.
"""

import pytest
import torch

TORCH_TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def cap_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_TEST_THREADS)
    yield
    torch.set_num_threads(before)
