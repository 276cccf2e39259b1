"""Torch's intra-op threads in a pytest-xdist worker.

Each worker process would otherwise run torch on every core of the host,
so N workers on C cores keep N x C threads busy: torch's OpenMP threads
then spin against each other. On an 8-core CPU host a port test of small
products that takes 6 s on one thread took 166 s on eight beside a running
suite, and 431-532 s inside a whole ``-n 6`` run. Imported by every port
test file, this gives a worker C // N threads (at least one); a run
without xdist keeps torch's default.
A test that wants another count sets it and restores this one, as the
``two_threads`` and ``_one_thread`` fixtures do.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
