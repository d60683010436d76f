"""The port's side of a test file on one CPU thread: import `one_torch_thread`
into the file (an autouse, module-scoped fixture).

The tier-1 run gives each of six workers a whole file on an 8-core machine;
torch's intra-op pool of eight threads per worker then fights the others
for the cores, and a file of small-op models or train steps slows by tens
of times."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
