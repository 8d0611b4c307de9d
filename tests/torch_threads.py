"""One intra-op thread for torch in the port's CPU tests.

The suite runs on several pytest-xdist workers at once, each also running
XLA's own thread pool for the JAX reference. With torch's default of one
OpenMP thread a core in every worker, each worker's parallel regions wait
on threads that the others have descheduled, and the port's files run
three to four times slower than alone. Each port test
module imports :func:`capped_torch_threads` (an autouse fixture), which
holds torch to :data:`TORCH_TEST_THREADS` intra-op threads for the test
and sets ``OMP_NUM_THREADS`` for the processes the test spawns (ranks, fleet
workers, fresh interpreters), restoring both after it.
"""

import pytest
import torch

TORCH_TEST_THREADS = 1


@pytest.fixture(autouse=True)
def capped_torch_threads(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_TEST_THREADS)
    monkeypatch.setenv("OMP_NUM_THREADS", str(TORCH_TEST_THREADS))
    try:
        yield
    finally:
        torch.set_num_threads(prev)
