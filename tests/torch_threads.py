"""Torch CPU threads for the port's tests.

Under pytest-xdist every worker is a process, and torch's default pool
(one thread per core) in several of them at once oversubscribes the
cores: a torch-heavy test file ran 5.6× slower beside five busy workers
than alone.  Each port test module imports this fixture, which gives its
worker the cores divided by the worker count and restores the pool after.
A module that hashes with the host MiMC library (OpenMP, one thread per
core by default) imports `mimc_threads_per_worker` too, which does the
same for that library.
"""

import os

import pytest
import torch


def _per_worker() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(_per_worker())
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def mimc_threads_per_worker():
    from zktls_tpu_torch.utils import native

    before = native.mimc_threads()
    native.set_mimc_threads(_per_worker())
    yield
    native.set_mimc_threads(before)
