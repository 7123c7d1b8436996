"""Each pytest-xdist worker's share of the CPU for torch.

Under `pytest -n N` every worker would run torch's CPU thread pool as wide
as the machine, so N workers oversubscribe the cores and the port's model
tests slow down forty-fold or more (the bench twin's `--profile` test on
an 8-core machine: 7 s alone, over 480 s beside five copies of itself,
13 s beside them at one thread each).  `share_cores()` gives a
worker its share of the cores, for torch's intra-op threads and, through
OMP_NUM_THREADS, for the subprocesses a test starts (a decoder in a fresh
process then computes with as many threads as the encoder).  Outside xdist
it does nothing.
"""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        threads = max(1, (os.cpu_count() or 1) // workers)
        torch.set_num_threads(threads)
        os.environ["OMP_NUM_THREADS"] = str(threads)
