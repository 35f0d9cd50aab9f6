"""Shared fixtures of the benchmark's own tests (``pytest benchmark/tests``):
one torch CPU thread per file, and a cell driven on the CPU at a small
size through the harness's own entry (the look for a card skipped)."""

import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The traffic at a size a CPU test holds: two pairs a step.
SMALL = {'batch': 2, 'pool_size': 4, 'steps_per_call': 2,
         'distinct_batches': 2, 'checked_calls': 2, 'warmup_calls': 1,
         'warmup_blocks': 1}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda', 0)


def small_traffic(monkeypatch):
    from benchmark.harness import manifest
    read = manifest.read_traffic

    def small(path):
        t = read(path)
        t.update(SMALL)
        return t
    monkeypatch.setattr(manifest, 'read_traffic', small)


def run_cell(monkeypatch, workload, seed=2 ** 31 + 11, fault=None,
             dtype=None, device=None, trace=False):
    """One run of ``workload`` through ``main.run`` at the small traffic,
    on the CPU unless ``device``; ``fault`` planted under the timed path,
    ``dtype`` the program's MODEL.DTYPE. Returns (rc, the result line)."""
    from benchmark.harness import generators, main, manifest
    small_traffic(monkeypatch)
    if fault is not None or dtype is not None:
        kind_fns = dict(generators.KINDS)

        def wrapped(kind):
            def fn(cfg, traffic, opts):
                return kind_fns[kind](cfg, traffic,
                                      dict(opts, fault=fault, dtype=dtype))
            return fn
        monkeypatch.setattr(generators, 'KINDS',
                            {k: wrapped(k) for k in kind_fns})
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main.run(['--workload', workload, '--seed', str(seed),
                       '--seconds', '0.05', '--trace', str(int(trace))],
                      time.perf_counter(),
                      device=device or torch.device('cpu'))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
