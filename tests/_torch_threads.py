"""Runs torch and numpy's BLAS on one thread while a port test module
runs.

The tier-1 suite runs in six xdist workers on the host's cores.  With
more than one thread, every parallel torch op or BLAS call (OpenBLAS,
under numpy) ends at a barrier of its threads, and on an oversubscribed
host a descheduled thread holds the others there for a time slice: a
test that takes 1.6 s alone took 72.5 s beside 12 busy processes, and
1.6 s again with one BLAS thread.  One thread has no barrier.  A test
module of the port imports ``bounded_torch_threads`` (an autouse,
module-scoped fixture), which pytest then applies to every test there;
the processes its tests start (process pools, fleet workers, CLIs)
inherit ``OMP_NUM_THREADS`` and ``OPENBLAS_NUM_THREADS`` of 1.  No test
of the port measures a speed that needs more threads."""

import os

import pytest
import torch
from threadpoolctl import threadpool_limits

THREADS = 1
_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")


@pytest.fixture(autouse=True, scope="module")
def bounded_torch_threads():
    n = torch.get_num_threads()
    env = {k: os.environ.get(k) for k in _ENV}
    torch.set_num_threads(THREADS)
    os.environ.update({k: str(THREADS) for k in _ENV})
    with threadpool_limits(limits=THREADS, user_api="blas"):
        yield
    torch.set_num_threads(n)
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
