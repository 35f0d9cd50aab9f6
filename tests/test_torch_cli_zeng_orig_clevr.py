"""The port's train and eval entry points on the CPU for the last three
YAMLs of ``config/`` to be ported, with the plain versions of the
kernels: pds-coco and s-coco zeng-orig (the NoOp 'all_points' head,
SmoothL1 on the perspective field) and CLEVR-Change zhang (ChangeAwarePrep
pairs, the TripletHead), one training step at batch 2 each, run to
``DONE!`` with finite logged losses; eval of both zeng-orig YAMLs through
predict's RANSAC fit, from the checkpoint that training wrote, prints a
finite MACE. Eval refuses the CLEVR-Change config, whose pairs have no
ground-truth homography.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_cli_pds import _run
from tests.torch_threads import one_torch_thread  # noqa: F401

ZENG_ORIG = ('config/pds-coco/zeng-orig-lr-1e-3.yaml',
             'config/s-coco/zeng-orig-lr-1e-3.yaml')
CLEVR = 'config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml'


def _train(config, log_dir):
    proc = _run(['bihome_torch.train', '--config_file', config,
                 '--synthetic', '--device', 'cpu', '--steps', '1',
                 '--batch_size', '2', '--epochs', '1',
                 '--set', f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=1'])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith('DONE!')
    return [json.loads(x) for x in
            (log_dir / 'metrics.jsonl').read_text().splitlines()]


@pytest.mark.parametrize('config', ZENG_ORIG,
                         ids=[c.split('config/')[1] for c in ZENG_ORIG])
def test_zeng_orig_train_and_eval_cli_on_cpu(config, tmp_path):
    log_dir = tmp_path / 'log'
    records = _train(config, log_dir)
    assert [r['step'] for r in records] == [1, 1]
    for key in ('loss/train', 'g_norm/value', 'mace/train'):
        assert np.isfinite(records[0][key]), key
    assert set(records[1]) == {'step', 'loss/test', 'mace/test'}
    ckpt = log_dir / 'model_000001.pth'
    assert '0.layer8.1.running_var' in torch.load(
        ckpt, weights_only=True)['model']
    proc = _run(['bihome_torch.eval', '--config_file', config, '--device',
                 'cpu', '--synthetic', '--steps', '1', '--batch_size', '2',
                 '--torch_ckpt', str(ckpt)])
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(': ', 1) for line in proc.stdout.splitlines()
                 if ': ' in line)
    assert int(lines['Number of params']) == 10_574_178
    assert np.isfinite(float(lines['Mean mace']))
    assert float(lines['Mean model time']) > 0


def test_clevr_train_cli_on_cpu_and_eval_refuses_it(tmp_path):
    log_dir = tmp_path / 'log'
    records = _train(CLEVR, log_dir)
    assert [r['step'] for r in records] == [1, 1]
    for key in ('loss/train', 'g_norm/value', 'loss_comp/ln1',
                'loss_comp/ln2', 'loss_comp/ln3'):
        assert np.isfinite(records[0][key]), key
    assert 'mace/train' not in records[0]
    assert set(records[1]) == {'step', 'loss/test'}
    proc = _run(['bihome_torch.eval', '--config_file', CLEVR, '--device',
                 'cpu', '--synthetic', '--steps', '1', '--batch_size', '2'])
    assert proc.returncode != 0
    assert 'no ground-truth homography' in proc.stderr
