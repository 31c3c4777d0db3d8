"""One torch CPU thread for a test module's duration.

The tier-1 run executes six test files at once (pytest-xdist), each in a
process whose torch would otherwise start one OpenMP thread a core; the
spinning threads of six such processes oversubscribe the machine and slow
every small-tensor test many times over. Import the fixture into a test
module to run that module on one thread (restored after it)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
