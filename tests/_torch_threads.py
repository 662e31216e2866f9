"""A thread budget for the port's CPU tests, imported first by every
`tests/test_torch_*.py`.

pytest-xdist runs N worker processes, and torch gives each one an
intra-op pool of one thread a CPU, so N workers oversubscribe the CPUs N
times over.  This sets each process's pool to its share of the CPUs,
cpu_count // N (at least 1), N from `PYTEST_XDIST_WORKER_COUNT` (1 in a
plain pytest run).  The processes a test starts inherit the same budget
through `OMP_NUM_THREADS`, unless it is set already."""

import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
