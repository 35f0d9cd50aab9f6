"""The manifest, the files it names, the arithmetic of the metrics and
the result line, on the CPU."""

import ast
import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark.harness import main, manifest, readers
from benchmark.tests.conftest import ROOT, SMALL, run_cell

BENCH = ROOT / 'benchmark'
M = manifest.load()
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'bihome_tpu'}


def test_manifest_keys_and_names():
    assert set(M) == KEYS
    assert M['command'] == ['python3', 'benchmark/run.py']
    assert M['paths'] == ['benchmark']
    assert 1 <= M['run_seconds'] <= 51
    names = ([c['name'] for c in M['configs']]
             + [w['name'] for w in M['workloads']]
             + [m['name'] for m in M['end_to_end'] + M['per_layer']])
    assert len(names) == len(set(names))
    for name in names + [w['traffic'] for w in M['workloads']]:
        assert manifest.NAME.match(name), name
    for m in M['end_to_end'] + M['per_layer']:
        assert manifest.UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'layer', 'moves', 'workloads'}
    for m in M['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert {m['name'] for m in M['end_to_end']} >= {'setup_s'}
    e2e = {m['name']: m for m in M['end_to_end']}
    for m in M['per_layer']:
        assert m['moves'] in e2e
        moved = e2e[m['moves']].get('workloads')
        for w in m['workloads']:
            assert moved is None or w in moved, (m['name'], w)
    assert len(json.dumps(M)) < 64 * 1024


def test_cells_fit_the_budget_and_chips():
    cells = M['workloads']
    four = [w for w in cells if w['chips'] == 4]
    assert all(w['chips'] in (1, 4) for w in cells)
    assert len(four) <= max(1, len(cells) // 4)
    per_run = M['run_seconds'] + 60
    assert 1200 + (2 + 14 * 24) * per_run + 24 * 180 <= 43200
    pairs = {(w['config'], w['traffic']) for w in cells}
    assert len(pairs) == len(cells)
    for w in cells:
        assert len(w['why']) <= 200


@pytest.mark.parametrize('workload', [w['name'] for w in M['workloads']])
def test_every_cell_finds_its_files(workload):
    cell = manifest.Cell(M, workload)
    assert cell.traffic['kind'] in ('train_pool', 'predict_closed')
    assert cell.config['name'] == cell.entry['config']
    assert cell.limits, 'no limits file'
    e2e = cell.metrics(trace=False)
    assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
    assert cell.metrics(trace=True)
    for m in e2e + cell.metrics(trace=True):
        assert callable(manifest.reader(m['name']))


def test_a_new_traffic_file_is_found_without_editing_any(tmp_path):
    copy = tmp_path / 'repo'
    shutil.copytree(BENCH, copy / 'benchmark')
    (copy / 'benchmark' / 'traffic' / 'dummy-mix.txt').write_text(
        'kind = train_pool\nbatch = 4\n')
    m = json.loads((ROOT / 'BENCHMARK.json').read_text())
    m['workloads'].append({'name': 'pds-detone-orig.dummy', 'chips': 1,
                           'config': 'pds-detone-orig',
                           'traffic': 'dummy-mix', 'why': 'a test'})
    cell = manifest.Cell(m, 'pds-detone-orig.dummy', copy / 'benchmark')
    assert cell.traffic == {'kind': 'train_pool', 'batch': 4}
    assert cell.config['name'] == 'pds-detone-orig'
    assert cell.limits is None


def test_rate_and_percentiles_take_every_sample():
    lat = [i / 1000 for i in range(1, 101)]          # 1..100 ms
    assert readers.percentile(lat, 95) == 0.095
    assert readers.percentile(lat, 50) == 0.050
    assert readers.percentile([0.2], 95) == 0.2
    ctx = {'calls': 100, 'pairs': 6400, 'window_s': 4.0,
           'latencies_s': lat}
    assert manifest.reader('predict_pairs_per_s')(ctx) == 1600.0
    assert manifest.reader('predict_ms_p95')(ctx) == pytest.approx(95.0)
    train = {'steps': 50, 'pairs': 3200, 'window_s': 8.0}
    assert manifest.reader('train_pairs_per_s')(train) == 400.0
    assert manifest.reader('predict_ms_p95')(train) is None


def test_traced_readers_and_nothing_to_read():
    ctx = {'steps': 10, 'window_s': 2.0, 'step_flops': 1e12,
           'phases': {'units': 4.0, 'start-fwd0': 8.0, 'fwd0-fwd1': 4.0,
                      'fwd1-head1': 12.0, 'head1-bwd1': 8.0,
                      'bwd1-opt1': 2.0},
           'trace': {'busy_s': 0.6, 'window_s': 1.0, 'launches': 500,
                     'units': 5, 'port_kernel_s': 0.01,
                     'port_bound_s': 0.002}}
    read = {m: manifest.reader(m)(ctx) for m in (
        'datagen_ms.train', 'backbone_ms.train', 'head_loss_ms.train',
        'optimizer_ms.train', 'idle_share.train', 'launches_per_step.train',
        'kernel_roofline.train', 'mfu.train')}
    assert read == pytest.approx({
        'datagen_ms.train': 2.0, 'backbone_ms.train': 3.0,
        'head_loss_ms.train': 3.0, 'optimizer_ms.train': 0.5,
        'idle_share.train': 40.0, 'launches_per_step.train': 100.0,
        'kernel_roofline.train': 20.0, 'mfu.train': 1e12 * 10 / 2.0
        / 495e12 * 100})
    ctx['trace']['port_kernel_s'] = 0.0
    assert manifest.reader('kernel_roofline.train')(ctx) is None
    assert manifest.reader('backbone_ms.predict')(ctx) is None


def test_the_result_line_has_the_contracts_keys(monkeypatch, capsys):
    rc, line = run_cell(monkeypatch, 'pds-detone-orig.train-b128')
    assert rc == 0
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics',
                          'device', 'checks']
    assert set(line['metrics']) == {'train_pairs_per_s', 'peak_mem_gib',
                                    'setup_s'}
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'}
    assert set(line['checks']) == set(manifest.Cell(
        M, 'pds-detone-orig.train-b128').limits)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith('correct ')
    assert all(e.startswith('check ') for e in err[-4:-1])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob('*.py')))
def test_no_jax_and_a_reference_apart_from_the_program(path):
    tops = {m.split('.')[0] for m in _imports(BENCH / path)}
    assert not tops & FORBIDDEN
    if path.startswith('reference/'):
        assert 'bihome_torch' not in tops


def test_the_loaded_module_check_compares_whole_top_level_names():
    assert main.forbidden_modules({'bihome_torch': 1, 'bihome_torch.ops': 1,
                                   'jaxtyping': 1, 'torch': 1}) == []
    assert main.forbidden_modules({'jax.numpy': 1, 'bihome_tpu': 1,
                                   'flax': 1}) == ['bihome_tpu', 'flax',
                                                   'jax.numpy']


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = main.run(['--workload', 'pds-detone-orig.train-b128', '--seed',
                   '1', '--seconds', '1', '--trace', '0'], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ''


class _HostEvent:
    """A CUDA event's interface on the host clock, for a traced run on
    the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.mark.parametrize('workload', ['pds-zeng-bihome.train-b64',
                                      'pds-zeng-bihome.predict-b64'])
def test_a_traced_run_reads_its_per_layer_metrics(monkeypatch, workload):
    """The traced path on the CPU: the phase marks (host-clock events), the
    port's kernel wrappers logged, a CPU-only profile, the counted
    operations. Device numbers read nothing here (no kernels), so the
    roofline is left out, as a reader that finds nothing leaves it."""
    import torch
    from benchmark.harness import trace
    monkeypatch.setattr(torch.cuda, 'Event', _HostEvent)

    def cpu_profile(block):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            block()
            wall = time.perf_counter() - t0
        return prof, wall
    monkeypatch.setattr(trace, 'profile', cpu_profile)
    monkeypatch.setitem(SMALL, 'trace_steps', 1)
    monkeypatch.setitem(SMALL, 'trace_calls', 1)
    rc, line = run_cell(monkeypatch, workload, trace=True)
    assert rc == 0
    cell = manifest.Cell(M, workload)
    expected = {m['name'] for m in cell.metrics(trace=True)}
    got = set(line['metrics'])
    assert got == expected - {'kernel_roofline.train',
                              'kernel_roofline.predict'}
    for name, m in line['metrics'].items():
        assert m['value'] >= 0, name
    assert line['breakdown']['idle_gaps'] == []
