"""One intra-op thread for the port's test files that import
``one_torch_thread``: their nets are tiny, and under a parallel test run
torch's thread pool in every worker oversubscribes the cores (six workers'
pools on eight cores made one toy training step several times slower)."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch at one intra-op thread for the module's tests, and
    ``OMP_NUM_THREADS=1`` for the processes they start; both restored
    after the module."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env
