"""One torch CPU thread for a whole test file, for the parallel test run.

A file takes it with ``from tests.torch_threads import one_torch_thread``
(the import makes the autouse fixture the file's own). The run's workers
each run a file at a time; with torch's own pool of a thread per core in
every worker, the slowest files oversubscribe the cores.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while the file runs: in this process,
    and through OMP_NUM_THREADS in the port's entry points the file starts
    as subprocesses."""
    threads = torch.get_num_threads()
    omp = os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp
