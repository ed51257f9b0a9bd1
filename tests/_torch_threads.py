"""Caps torch's CPU threads in the port's tests at this process's share of
the cores.

Under pytest-xdist every worker is a process of its own, and torch gives
each the machine's whole thread pool: six workers on eight cores then run
48 spinning OpenMP threads, and a step of a full-width model on the CPU
takes about a hundred times as long as alone.  Importing this module (every
``test_torch_*.py`` does) sets torch's intra-op threads to the cores over
the workers, at least 1, and ``OMP_NUM_THREADS`` to the same for the
interpreters the tests start.
"""

import os

import torch


def cpu_share() -> int:
    """The cores over pytest-xdist's workers (1 without xdist), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


THREADS = cpu_share()
torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
