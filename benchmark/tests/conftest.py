import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny models run faster on few threads beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
