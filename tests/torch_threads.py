"""One intra-op thread for the port's CPU tests.

The suite runs six pytest workers on eight cores.  PyTorch's CPU ops
would each start an OpenMP team of as many threads as there are cores,
and on oversubscribed cores those teams wait on each other: a test of
small tensors ran five times slower beside busy cores than on one
thread.  A port test module imports ``one_torch_thread``; the fixture
applies to that module and restores the count after it."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
