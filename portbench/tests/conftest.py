"""CPU tests of the benchmark: torch held to two threads."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
