"""The harness's CPU runs here move tensors of a few hundred rows: one
torch thread does them as fast as many, and a pool of many only contends
with the other test workers for the cores (a tenth of the time under
load)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
