"""Give PyTorch's CPU thread pool the share of the machine one test process
gets when pytest-xdist runs the suite in several workers.

Each xdist worker is a process of its own, and PyTorch would take every
core in each of them: with six workers on eight cores that is forty-eight
OpenMP threads, which spin between operations and starve the other
workers, JAX's compiles included. On an eight-core machine the port's
tests in six workers took 83-93 s of wall time and about 8 min of CPU time
with ``cpu_count // workers`` threads (at least one) each, against 195 s
and 23 min with the default. ``OMP_NUM_THREADS``
is set before PyTorch is imported and left set for the worker's life:
setting the thread count through ``torch.set_num_threads`` alone, or
restoring the variable after the import, gives back most of the slowdown.
A run without xdist keeps PyTorch's default.

The setting is not confined to the port's tests: every worker collects
``tests/port`` and so loads this file, and the JAX package's tests that the
same worker runs afterwards run with the same ``OMP_NUM_THREADS`` and
PyTorch thread count.
"""

import os

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers > 1:
    _threads = max(1, (os.cpu_count() or 1) // _workers)
    os.environ["OMP_NUM_THREADS"] = str(_threads)

import torch  # noqa: E402

if _workers > 1:
    torch.set_num_threads(_threads)
