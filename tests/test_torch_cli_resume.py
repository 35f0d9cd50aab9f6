"""Resume through the port's train entry point, on the CPU, streamed
(``--feed stream``) from an ``.npy`` folder the test writes (the epoch
sampler's RandomState in the loop), for s-coco detone-orig and pds-coco
zeng-biHomE (its pair and DSAC generators too), at batch 2, one step per
epoch (resume through the device pool: ``tests/test_torch_feed_pool.py``):

* one epoch, then the same command with ``--epochs 2`` in the same
  LOGGING.DIR, gives exactly the losses, test records and weights of two
  epochs without a stop (tolerance: exact; the records but their
  wall-clock throughput);
* with SOLVER.RESTART_LEARNING_RATE the resumed run keeps the step and
  starts Adam empty at count 0;
* a checkpoint whose optimizer state does not fit the trainable set
  resumes weights-only with a fresh optimizer.
"""

import json
import shutil

import pytest
import torch

from bihome_torch import train
from tests.test_torch_host_data import (  # noqa: F401
    cpu_test_env, images, write_npys)

pytestmark = pytest.mark.usefixtures('cpu_test_env')

CONFIGS = ('config/s-coco/detone-orig-lr-5e-3.yaml',
           'config/pds-coco/zeng-bihome-lr-1e-3.yaml')


def _records(log_dir):
    """The logged records without the wall-clock throughput."""
    records = [json.loads(x) for x in
               (log_dir / 'metrics.jsonl').read_text().splitlines()]
    return [{k: v for k, v in r.items()
             if k != 'throughput/pairs_per_sec_per_chip'} for r in records]


@pytest.mark.parametrize('config', CONFIGS)
def test_resume_continues_exactly(config, tmp_path, capsys):
    split = write_npys(tmp_path / 'npy', images(5, 240, 320, 3))

    def run(log_dir, epochs, *sets):
        args = ['--config_file', config, '--steps', '1', '--batch_size', '2',
                '--epochs', str(epochs), '--device', 'cpu', '--feed', 'stream',
                '--set', f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=1',
                '--set', f'DATA.TRAIN_SPLIT={split}',
                '--set', f'DATA.TEST_SPLIT={split}',
                '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz']
        for item in sets:
            args += ['--set', item]
        return train.main(args)

    whole = run(tmp_path / 'a', 2)
    for path in (tmp_path / 'a').glob('*.pth'):
        path.unlink()       # a few hundred MB each
    first = run(tmp_path / 'b', 1)
    step1 = tmp_path / 'b' / 'model_000001.pth'
    for name in ('c', 'd'):
        (tmp_path / name).mkdir()
        shutil.copy(step1, tmp_path / name)
    capsys.readouterr()
    resumed = run(tmp_path / 'b', 2)
    out = capsys.readouterr().out
    assert 'Resumed from' in out and 'optimizer count 1' in out
    assert 'from their seeds' not in out
    assert resumed['start_step'] == 1 and resumed['step'] == 2
    assert torch.equal(torch.cat([first['losses'], resumed['losses']]),
                       whole['losses'])
    assert _records(tmp_path / 'b') == _records(tmp_path / 'a')
    want = whole['model'].state_dict()
    for k, v in resumed['model'].state_dict().items():
        assert torch.equal(v, want[k]), k
    assert resumed['optimizer'].count == whole['optimizer'].count == 2
    shutil.rmtree(tmp_path / 'b')

    restarted = run(tmp_path / 'c', 2, 'SOLVER.RESTART_LEARNING_RATE=true')
    out = capsys.readouterr().out
    assert 'Resumed from' in out and 'optimizer count 0' in out
    assert restarted['start_step'] == 1 and restarted['step'] == 2
    assert restarted['optimizer'].count == 1
    shutil.rmtree(tmp_path / 'c')

    # Drop the last trainable tensor from the saved optimizer state.
    path = tmp_path / 'd' / 'model_000001.pth'
    data = torch.load(path, weights_only=True)
    group = data['optimizer']['adam']['param_groups'][0]
    data['optimizer']['adam']['state'].pop(group['params'].pop())
    torch.save(data, path)
    changed = run(tmp_path / 'd', 2)
    out = capsys.readouterr().out
    assert out.count('resuming weights-only') == 1
    assert changed['start_step'] == 1 and changed['optimizer'].count == 1
    start = first['model'].state_dict()
    for k, v in changed['initial_state'].items():
        assert torch.equal(v, start[k]), k
