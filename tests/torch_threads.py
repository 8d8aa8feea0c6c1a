"""Torch CPU threads for the port's tests.

Under pytest-xdist every worker is a process, and torch's default pool
(one thread per core) in several of them at once oversubscribes the
cores: a torch-heavy test file ran 5.6× slower beside five busy workers
than alone.  Each port test module imports this fixture, which gives its
worker the cores divided by the worker count and restores the pool after.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
