"""One torch intra-op thread for the port's CPU tests. The suite runs on
several pytest-xdist workers at once, each spawning ranks of its own;
torch's default of one thread a core then oversubscribes the cores, and
every parallel region waits on threads the other workers hold (a test
took up to 13x its time alone). A test module imports
:func:`one_torch_thread`, an autouse fixture: one thread while the
module runs, the count restored after."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
