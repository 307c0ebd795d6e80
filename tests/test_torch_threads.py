"""Shared autouse fixture of the tests/test_torch_*.py files (imported by
each; this module holds no tests): the port's tests run torch on one
intra-op thread. Their tensors are tiny, and the
suite runs several test processes side by side, where torch's default of
one thread per core would crowd out the timing-sensitive cluster tests."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
