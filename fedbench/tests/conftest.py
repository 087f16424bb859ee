"""The benchmark's CPU tests run torch at its full widths on small
batches. Under pytest-xdist every worker's torch would take every core,
and the workers then wait on each other's threads, so each test here runs
with two threads (restored after it)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
