"""The port's train and eval entry points on the CPU for the PDS-COCO
configs this port runs (with the plain versions of the kernels): two
training steps at batch 4 run to ``DONE!`` with finite logged losses, and
eval prints a finite MACE. The ResNet34 and ContentAware checkpoints
that train writes are read back by ``eval --torch_ckpt`` (the reference
``0.resnet34.*`` and ``0.feature_extractor.*`` keys).

The configs are divided between this file (the biHomE-loss configs,
zeng-biHomE and detone-biHomE) and tests/test_torch_cli_pds_regressors.py
(detone-orig, nguyen-orig, zhang-orig and the eval runs), which runs the
same tests on its share: a run with ``-p xdist --dist loadfile`` hands
each file to one worker, and one file of all eight cases took 930 s.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PDS = ('zeng-bihome-lr-1e-3', 'detone-bihome-lr-5e-3')
# Parameters of the predict model (the backbone).
PARAMS = {'detone-orig-lr-5e-3': 21_285_640, 'zhang-orig-lr-1e-2': 21_286_062}


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    return subprocess.run([sys.executable, '-m', *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _eval(config, *extra):
    proc = _run(['bihome_torch.eval', '--config_file', config, '--device',
                 'cpu', '--synthetic', '--steps', '2', '--batch_size', '4',
                 *extra])
    assert proc.returncode == 0, proc.stderr
    return dict(line.split(': ', 1) for line in proc.stdout.splitlines()
                if ': ' in line)


@pytest.mark.parametrize('name', PDS)
def test_train_cli_runs_pds_config_on_cpu(name, tmp_path):
    check_train_cli(name, tmp_path)


def check_train_cli(name, tmp_path):
    """Train two steps of pds-coco/``name`` and check the log, the
    checkpoint and (ResNet34 and ContentAware) its eval."""
    log_dir = tmp_path / 'log'
    config = f'config/pds-coco/{name}.yaml'
    proc = _run(['bihome_torch.train', '--config_file', config,
                 '--synthetic', '--device', 'cpu', '--steps', '2',
                 '--batch_size', '4', '--epochs', '1',
                 '--set', f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=1',
                 '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz'])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith('DONE!')
    records = [json.loads(x) for x in
               (log_dir / 'metrics.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records] == [1, 2, 2]
    for rec in records[:2]:
        assert np.isfinite(rec['loss/train']) and np.isfinite(
            rec['g_norm/value'])
    assert 'loss/test' in records[2]
    bihome = 'bihome' in name
    assert ('Auxiliary resnet (npz) loaded' in proc.stdout) == bihome
    state = torch.load(log_dir / 'model_000002.pth', weights_only=True)
    keys = set(state['model'])
    if name.startswith('zeng'):
        assert '0.layer8.1.running_var' in keys
    else:
        assert '0.resnet34.fc.weight' in keys
        assert ('1.auxiliary_resnet.conv1.weight' in keys) == bihome
        assert ('0.feature_extractor.layer3.1.running_var' in keys) == \
            name.startswith('zhang')
        if name in PARAMS:
            lines = _eval(config, '--torch_ckpt',
                          str(log_dir / 'model_000002.pth'))
            assert int(lines['Number of params']) == PARAMS[name]
            assert np.isfinite(float(lines['Mean mace']))
