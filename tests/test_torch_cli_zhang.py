"""The port's train and eval entry points on the CPU for the zhang configs
not run by tests/test_torch_cli_pds.py (s-coco/zhang-orig, the ContentAware
backbone with the TripletHead; s-coco and pds-coco/zhang-bihome, the same
backbone with the biHomE loss on its deltas), with the plain versions of
the kernels: two training steps at batch 4 run to ``DONE!`` with finite
logged losses and the head's terms, and eval prints a finite MACE.
"""

import json

import numpy as np
import pytest

from tests.test_torch_cli_pds import _eval, _run
from tests.torch_threads import one_torch_thread  # noqa: F401

CONFIGS = ('config/s-coco/zhang-orig-lr-1e-2.yaml',
           'config/s-coco/zhang-bihome-lr-1e-2.yaml',
           'config/pds-coco/zhang-bihome-lr-1e-2.yaml')


@pytest.mark.parametrize('config', CONFIGS,
                         ids=[c.split('config/')[1] for c in CONFIGS])
def test_zhang_train_and_eval_cli_on_cpu(config, tmp_path):
    log_dir = tmp_path / 'log'
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
        for key in ('loss/train', 'g_norm/value', 'loss_comp/ln1',
                    'loss_comp/ln2', 'loss_comp/ln3'):
            assert np.isfinite(rec[key]), key
    lines = _eval(config, '--torch_ckpt', str(log_dir / 'model_000002.pth'))
    assert int(lines['Number of params']) == 21_286_062
    assert np.isfinite(float(lines['Mean mace']))
