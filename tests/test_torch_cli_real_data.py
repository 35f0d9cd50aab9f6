"""The port's train and eval entry points on files each test writes, on
the CPU (the plain versions of the kernels).

* ``python -m bihome_torch.train`` / ``eval`` without ``--synthetic`` run
  from a JPEG folder, an ``.npy`` folder, a ``.bhpk`` pack and a CIFAR-10
  pickle directory (train and eval) and a CLEVR-Change layout (train),
  and print the dataset class each split got.
* Streamed against pooled: a folder of ``.npy`` files holding the
  synthetic pool's own images gives exactly the losses and test records
  of ``--synthetic`` (the same epoch indices, the same pairs), and eval
  the same MACE. Tolerance: exact.
* ``eval --ckpt`` on a log directory and on a file gives the MACE of
  ``--torch_ckpt``; without either, eval loads the newest checkpoint in
  LOGGING.DIR; ``--log`` appends one line per sample.
* MODEL.PRETRAINED: a zeng-orig checkpoint warm-starts zeng-biHomE's
  backbone and leaves its extractor alone.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from bihome_torch import eval as teval
from bihome_torch import train
from bihome_torch.data import datasets
from bihome_torch.data.pack import write_pack
from bihome_torch.training import checkpoint
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_checkpoint import _built
from tests.test_torch_host_data import (  # noqa: F401
    cpu_test_env, images, write_cifar, write_clevr, write_jpegs, write_npys)

pytestmark = pytest.mark.usefixtures('cpu_test_env')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETONE = 'config/s-coco/detone-orig-lr-5e-3.yaml'
PDS_DETONE = 'config/pds-coco/detone-orig-lr-5e-3.yaml'
ZENG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'
CLEVR = 'config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml'


def _run(args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run([sys.executable, '-m', *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _cifar_config(tmp_path):
    """s-coco detone-orig on 32x32 CIFAR images: the patch is the whole
    image (HomographyNetPrep rho 8, patch 32)."""
    with open(os.path.join(REPO, DETONE)) as f:
        config = yaml.safe_load(f)
    config['DATA']['NAME'] = 'cifar10'
    prep = config['DATA']['TRANSFORMS'][0]['HomographyNetPrep']
    prep[0], prep[1] = 8, 32
    config['DATA']['TEST_TRANSFORM'] = config['DATA']['TRANSFORMS']
    path = tmp_path / 'cifar.yaml'
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _main(module, args, capsys):
    module.main(args)
    return capsys.readouterr().out


@pytest.mark.parametrize('source', ['jpeg', 'npy', 'pack', 'cifar'])
def test_train_and_eval_clis_run_from_files(source, tmp_path, capsys):
    """``python -m`` for the JPEG folder; the entry points' ``main`` for
    the others."""
    config, batch, size = DETONE, '2', ()
    if source == 'jpeg':
        split = write_jpegs(tmp_path / 'jpg', images(4, 480, 640, 0))
        want = 'ImageFolderDataset (4)'
    elif source == 'npy':
        split = write_npys(tmp_path / 'npy', images(4, 240, 320, 1))
        want = 'ImageFolderDataset (4)'
    elif source == 'pack':
        split = str(tmp_path / 'pack.bhpk')
        write_pack(split, images(3, 240, 320, 2))
        want = 'PackDataset (3)'
    else:
        split = write_cifar(str(tmp_path / 'cifar'), per_batch=4)
        config, batch, size = _cifar_config(tmp_path), '4', ('32', '32')
        # The test batch where the path names 'test' (as in JAX).
        want = f'Cifar10Dataset ({4 if "test" in split else 20})'
    log_dir = tmp_path / 'log'
    sets = ['--set', f'DATA.TRAIN_SPLIT={split}',
            '--set', f'DATA.TEST_SPLIT={split}']
    if size:
        sets += ['--image_size', *size]
    if source == 'jpeg':
        def run(module, args):
            return _run([f'bihome_torch.{module}', *args])
    else:
        def run(module, args):
            return _main({'train': train, 'eval': teval}[module], args,
                         capsys)
    out = run('train', ['--config_file', config, '--device', 'cpu',
                        '--steps', '1', '--batch_size', batch, '--epochs',
                        '1', '--set', f'LOGGING.DIR={log_dir}', *sets])
    assert f'Train split: {want} from {split}' in out
    assert f'Test split: {want} from {split}' in out
    records = [json.loads(x) for x in
               (log_dir / 'metrics.jsonl').read_text().splitlines()]
    assert np.isfinite(records[-1]['loss/test'])
    out = run('eval', ['--config_file', config, '--device', 'cpu',
                       '--steps', '1', '--batch_size', batch,
                       '--ckpt', str(log_dir), '--skip_timing', *sets])
    assert f'Test split: {want} from {split}' in out
    assert f'Loaded checkpoint step 1 from {log_dir}' in out
    lines = dict(line.split(': ', 1) for line in out.splitlines()
                 if ': ' in line)
    assert np.isfinite(float(lines['Mean mace']))


def test_train_cli_runs_from_a_clevr_layout(tmp_path):
    root = write_clevr(str(tmp_path / 'clevr'), 3, 120, 160)
    log_dir = tmp_path / 'log'
    out = _run(['bihome_torch.train', '--config_file', CLEVR, '--device',
                'cpu', '--steps', '1', '--batch_size', '2', '--epochs', '1',
                '--image_size', '160', '120',
                '--set', f'LOGGING.DIR={log_dir}',
                '--set', f'DATA.TRAIN_SPLIT={root}',
                '--set', f'DATA.TEST_SPLIT={root}'])
    assert f'Train split: ClevrChangeDataset (3) from {root}' in out
    records = [json.loads(x) for x in
               (log_dir / 'metrics.jsonl').read_text().splitlines()]
    assert np.isfinite(records[-1]['loss/test'])
    assert (log_dir / 'model_000001.pth').exists()


@pytest.fixture(scope='module')
def pool_folders(tmp_path_factory):
    """The synthetic train (seed 0) and test (seed 1) pools as .npy files,
    in the pools' order."""
    root = tmp_path_factory.mktemp('pools')
    yield tuple(write_npys(root / name,
                           datasets.SyntheticDataset(seed=seed).pool)
                for name, seed in (('train', 0), ('test', 1)))
    shutil.rmtree(root, ignore_errors=True)


def test_streamed_files_equal_the_device_pool(pool_folders, tmp_path):
    """pds-coco detone-orig: the PDS distortion's draws come from the same
    generator in both routes."""
    train_dir, test_dir = pool_folders
    common = ['--config_file', PDS_DETONE, '--steps', '1', '--batch_size',
              '2', '--epochs', '2', '--device', 'cpu',
              '--set', 'LOGGING.STEP=1']
    pooled = train.main(common + ['--synthetic', '--set',
                                  f'LOGGING.DIR={tmp_path / "a"}'])
    streamed = train.main(common + [
        '--set', f'LOGGING.DIR={tmp_path / "b"}',
        '--set', f'DATA.TRAIN_SPLIT={train_dir}',
        '--set', f'DATA.TEST_SPLIT={test_dir}'])
    assert torch.equal(pooled['losses'], streamed['losses'])
    assert pooled['records'] == streamed['records']
    assert len(streamed['wait_ms']) == 2
    maces = [teval.main(['--config_file', PDS_DETONE, '--steps', '2',
                         '--batch_size', '2', '--device', 'cpu',
                         '--skip_timing', '--ckpt', str(tmp_path / 'a'),
                         *extra])['maces']
             for extra in (['--synthetic'],
                           ['--set', f'DATA.TEST_SPLIT={test_dir}'])]
    np.testing.assert_array_equal(maces[0], maces[1])


def test_eval_ckpt_autoload_and_log(tmp_path):
    log_dir = tmp_path / 'log'
    train.main(['--config_file', DETONE, '--synthetic', '--steps', '1',
                '--batch_size', '2', '--epochs', '2', '--device', 'cpu',
                '--set', f'LOGGING.DIR={log_dir}'])
    common = ['--config_file', DETONE, '--synthetic', '--steps', '1',
              '--batch_size', '3', '--device', 'cpu', '--skip_timing']
    ref = teval.main(common + ['--torch_ckpt',
                               str(log_dir / 'model_000002.pth')])
    fresh = teval.main(common + ['--set', f'LOGGING.DIR={tmp_path / "no"}'])
    assert fresh['mean_mace'] != ref['mean_mace']
    log = tmp_path / 'mace.log'
    for extra in (['--ckpt', str(log_dir)],
                  ['--ckpt', str(log_dir / 'model_000002.pth')],
                  ['--set', f'LOGGING.DIR={log_dir}', '--log', str(log)]):
        got = teval.main(common + extra)
        np.testing.assert_array_equal(got['maces'], ref['maces'])
    lines = log.read_text().splitlines()
    assert [line.split(',')[0] for line in lines] == ['0', '1', '2']
    np.testing.assert_array_equal(
        [float(line.split(',')[1]) for line in lines], ref['maces'])
    with pytest.raises(FileNotFoundError):
        teval.main(common + ['--ckpt', str(tmp_path / 'no')])


def test_pretrained_zeng_orig_warm_starts_zeng_bihome(tmp_path, capsys):
    src = _built('config/pds-coco/zeng-orig-lr-1e-3.yaml', seed=7)
    checkpoint.CheckPointer(str(tmp_path / 'orig')).save(
        3, src.model, Optimizer(list(src.model.parameters()), lr=1e-3))
    result = train.main([
        '--config_file', ZENG, '--synthetic', '--steps', '1',
        '--batch_size', '2', '--epochs', '1', '--device', 'cpu',
        '--set', f'LOGGING.DIR={tmp_path / "log"}',
        '--set', f'MODEL.PRETRAINED={tmp_path / "orig"}',
        '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz'])
    out = capsys.readouterr().out
    n = len([k for k in src.model.backbone.state_dict()
             if not k.endswith('num_batches_tracked')])
    assert f'Pretrained: {n} tensors loaded, 0 shape-skipped' in out
    assert 'Pretrained model loaded!' in out
    initial = result['initial_state']
    for k, v in src.model.backbone.state_dict().items():
        assert torch.equal(initial[f'backbone.{k}'], v), k
    aux = _built(ZENG, ['MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz'])
    train.load_pretrained_resnets(aux)
    for k, v in aux.model.auxiliary_resnet.state_dict().items():
        assert torch.equal(initial[f'auxiliary_resnet.{k}'], v), k
