"""The port's entry points across 2 ranks on the CPU (gloo), as separate
processes: ``bihome_torch.train --multihost --coordinator 127.0.0.1:PORT
--num_processes 2 --process_id r --device cpu`` and ``bihome_torch.eval
--multihost`` (torchrun's environment), and the helpers they use
(``parallel.dist_util``, ``utils.model_zoo``) at world size 1 and 2.

Train (s-coco detone-orig, MSE: a loss that averages over the batch;
global batch 4, the synthetic images through a device pool of 8, the
whole pool on each rank, refreshed every 2 steps): the logged
first-step loss and MACE are the global batch's, the one-process run's
within rtol 1e-4 (float32 summation order: the batch norms' statistics
are summed over the ranks). With ``--pool_shard``: rank 0 alone writes
``metrics.jsonl`` (one line per log step) and the checkpoints; one
epoch, then a resume to two in the same LOGGING.DIR, logs exactly what
two epochs without a stop log (each rank's pool-draw generator is in the
checkpoint). Eval (S-COCO zeng-biHomE, DSAC, 3
iterations of 2 samples, split 2 / 1): its ``--log`` equals the
one-process log line for line. The backend and local rank each rank
takes from the host layout the ranks exchange, and ``init_from_args``
with a coordinator on the CPU.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bihome_torch.parallel import dist_util
from bihome_torch.utils import model_zoo
from tests import torch_dist_helpers as h

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CONFIG = 'config/s-coco/detone-orig-lr-5e-3.yaml'
EVAL_CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
TIMEOUT_S = 300


def _env():
    # One thread a process: the resume check is bitwise, and with two a
    # product may sum in another order while the pool refresher's thread
    # runs beside the step (about one run in ten under load).
    env = dict(os.environ)
    env['OMP_NUM_THREADS'] = '1'
    return env


def _start(module, args, ranks, extra_env=None):
    """``python -m module args`` started in one process, or as ``ranks``
    processes joined through ``--coordinator``."""
    base = [sys.executable, '-m', module] + args + ['--device', 'cpu']
    if ranks == 1:
        commands = [base]
    else:
        port = h.free_port()
        commands = [base + ['--multihost', '--coordinator',
                            f'127.0.0.1:{port}', '--num_processes',
                            str(ranks), '--process_id', str(r)]
                    for r in range(ranks)]
    env = _env()
    env.update(extra_env or {})
    return [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for c in commands]


def _finish(procs):
    """Each process's stdout, once all have ended; raises unless each
    exited with 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _train_args(log_dir, epochs, *extra):
    return ['--config_file', TRAIN_CONFIG, '--synthetic', '--steps', '2',
            '--batch_size', '4', '--epochs', str(epochs), '--pool_size', '8',
            '--pool_refresh_steps', '2', '--steps_per_call', '1',
            '--set', f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=1',
            *extra]


def _records(log_dir):
    lines = (log_dir / 'metrics.jsonl').read_text().splitlines()
    return [{k: v for k, v in json.loads(x).items()
             if k != 'throughput/pairs_per_sec_per_chip'} for x in lines]


@pytest.fixture(scope='module')
def train_runs(tmp_path_factory):
    """One process and 2 ranks on the same global batch and draws (the
    whole pool on each rank); 2 ranks with --pool_shard for two epochs,
    and for one epoch then resumed to two (these runs overlap)."""
    root = tmp_path_factory.mktemp('multihost_train')
    shard = '--pool_shard'
    started = {
        'one': _start('bihome_torch.train', _train_args(root / 'one', 1), 1),
        'two': _start('bihome_torch.train', _train_args(root / 'two', 1), 2),
        'whole': _start('bihome_torch.train',
                        _train_args(root / 'whole', 2, shard), 2),
        'first': _start('bihome_torch.train',
                        _train_args(root / 'resumed', 1, shard), 2)}
    outs = {name: _finish(procs) for name, procs in started.items()}
    outs['files_after_one'] = sorted(os.listdir(root / 'resumed'))
    outs['resumed'] = _finish(_start(
        'bihome_torch.train', _train_args(root / 'resumed', 2, shard), 2))
    outs['root'] = root
    yield outs
    shutil.rmtree(root, ignore_errors=True)     # checkpoints of ~100 MB


def test_rank_zero_alone_writes(train_runs):
    root = train_runs['root']
    # Two epochs of 2 steps at LOGGING.STEP 1: 4 step records and 2 test
    # records, each once; one checkpoint per epoch.
    records = _records(root / 'whole')
    assert [r['step'] for r in records] == [1, 2, 2, 3, 4, 4]
    assert sorted(os.listdir(root / 'whole')) == [
        'metrics.jsonl', 'model_000002.pth', 'model_000004.pth']
    assert train_runs['files_after_one'] == ['metrics.jsonl',
                                             'model_000002.pth']
    assert 'Distributed: 2 ranks, backend gloo' in train_runs['whole'][0]
    assert 'Distributed' not in train_runs['whole'][1]


def test_logged_loss_is_the_global_batch_loss(train_runs):
    root = train_runs['root']
    one, two = _records(root / 'one'), _records(root / 'two')
    np.testing.assert_allclose(two[0]['loss/train'], one[0]['loss/train'],
                               rtol=1e-4)
    np.testing.assert_allclose(two[0]['mace/train'], one[0]['mace/train'],
                               rtol=1e-4)


def test_resume_across_ranks_is_exact(train_runs):
    root = train_runs['root']
    assert 'Resumed from' in train_runs['resumed'][0]
    assert 'from their seeds' not in train_runs['resumed'][0]
    assert _records(root / 'resumed') == _records(root / 'whole')


def test_eval_log_across_ranks_equals_one_process(tmp_path):
    args = ['--config_file', EVAL_CONFIG, '--synthetic', '--steps', '3',
            '--batch_size', '2', '--skip_timing',
            '--set', f'LOGGING.DIR={tmp_path / "none"}']
    single = _start('bihome_torch.eval',
                    args + ['--log', str(tmp_path / 'one.log')], 1)
    port = h.free_port()
    procs = []
    for r in range(2):
        env = _env()
        env.update({'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port),
                    'RANK': str(r), 'WORLD_SIZE': '2', 'LOCAL_RANK': str(r)})
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'bihome_torch.eval'] + args
            + ['--log', str(tmp_path / 'two.log'), '--multihost',
               '--device', 'cpu'],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    _finish(single)
    outs = _finish(procs)
    one = (tmp_path / 'one.log').read_text().splitlines()
    assert len(one) == 6
    assert (tmp_path / 'two.log').read_text().splitlines() == one
    assert 'Mean mace' in outs[0] and 'Mean mace' not in outs[1]


@pytest.mark.parametrize('device_type, hosts, backend', [
    ('cuda', [('a', 1)], 'nccl'),
    ('cuda', [('a', 1), ('a', 1)], 'gloo'),        # two ranks on one card
    ('cuda', [('a', 2), ('a', 2)], 'nccl'),
    ('cuda', [('a', 1), ('b', 1)], 'nccl'),        # one process per host
    ('cuda', [('a', 4), ('b', 1), ('a', 4), ('b', 1)], 'gloo'),
    ('cuda', [('a', 4), ('b', 4), ('a', 4), ('b', 4)], 'nccl'),
    ('cpu', [('a', 0), ('b', 0)], 'gloo'),
])
def test_backend_of_a_host_layout(device_type, hosts, backend):
    from bihome_torch.parallel import mesh
    assert mesh.choose_backend(device_type, hosts) == backend


def test_local_ranks_of_a_host_layout():
    from bihome_torch.parallel import mesh
    hosts = [('a', 4), ('b', 4), ('a', 4), ('b', 4), ('a', 4)]
    assert [mesh.local_rank(hosts, r) for r in range(5)] == [0, 0, 1, 1, 2]


def test_init_from_args_with_a_coordinator():
    got = h.run_ranks(h.init_worker, 2, join=False)
    assert got == [{'device': 'cpu', 'backend': 'gloo', 'world': 2,
                    'rank': r, 'sum': 3.0} for r in range(2)]


def test_dist_util_in_one_process():
    assert dist_util.get_world_size() == 1
    assert dist_util.get_rank() == 0
    assert dist_util.is_main_process()
    dist_util.synchronize()
    data = {'maces': np.arange(3.0)}
    assert dist_util.all_gather(data) == [data]


def test_dist_util_and_model_zoo_on_two_ranks(tmp_path):
    (tmp_path / 'w.pth').write_bytes(b'weights')
    got = h.run_ranks(h.dist_util_worker, 2, str(tmp_path))
    assert [(g['world'], g['rank'], g['main']) for g in got] == [
        (2, 0, True), (2, 1, False)]
    for g in got:
        assert [x['rank'] for x in g['gathered']] == [0, 1]
        np.testing.assert_array_equal(g['gathered'][1]['maces'],
                                      np.arange(3.0) + 10)
        assert g['resolved'] == str(tmp_path / 'w.pth')


def test_model_zoo_paths_and_messages(tmp_path):
    path = tmp_path / 'local.pth'
    path.write_bytes(b'x')
    assert model_zoo.resolve_weights(str(path)) == str(path)
    with pytest.raises(FileNotFoundError):
        model_zoo.resolve_weights(str(tmp_path / 'missing.pth'))
    with pytest.raises(FileNotFoundError, match='has no network access'):
        model_zoo.resolve_weights('https://example.com/a/b.pth',
                                  str(tmp_path / 'cache'))
