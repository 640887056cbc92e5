"""torch's intra-op threads under pytest-xdist: each worker takes its share
of the cores this process may run on.

torch sizes its thread pool to every core by default, so N workers on C
cores ask for N x C threads, and torch's OpenMP regions wait on the threads
the host has descheduled. The port's tests (``tests/test_torch_*.py``, six
workers, ``--dist loadfile``, on an 8-core host) ran 1005 s by default and
280 s with two threads a worker, every test passing either way. Every
worker imports this module while it collects the tests, before any test
runs, so the share holds for the whole test run; subprocesses the tests
start inherit it through ``OMP_NUM_THREADS``. A run without workers keeps
torch's default.
"""
import math
import os

import torch


def worker_threads():
    """The intra-op threads a worker takes: ceil(cores / workers), or None
    outside a pytest-xdist worker."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if "PYTEST_XDIST_WORKER" not in os.environ or workers < 1:
        return None
    return max(1, math.ceil(len(os.sched_getaffinity(0)) / workers))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)


def test_workers_share_the_cores():
    if THREADS is None:
        assert "PYTEST_XDIST_WORKER" not in os.environ
        return
    assert torch.get_num_threads() == THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(THREADS)
