"""The device-pool feed of ``bihome_torch.train`` (``--feed pool``, JAX's
default), on the CPU.

Against the JAX package (tolerance: exact):

* ``trainer.pick_steps_per_call`` equals JAX's on a grid of epoch lengths
  and logging intervals;
* pools 0, 1 and 2 of a JPEG folder (and of the folder behind a host prep
  with random crops, and of a pack of its images, gathered by the native
  reader), built as ``train.py:210-223`` builds them (an epoch
  sampler seeded by the run's seed, ``load_image`` at its indices), the
  first by the source and the next two by its refresher thread, are
  bytewise JAX's; the states recorded at a pool's start rebuild it;
* ``pipeline.take_images`` gathers JAX's bytes on injected indices.

The port alone:

* the swap schedule: pool ``step // (K * refresh_blocks)`` serves each
  block, from a fresh start and from a resumed one, and pool 0 serves
  every block when the data fits one pool;
* the refresher re-raises a failed build in the loop and stops when
  closed, its queue full or not;
* a CLI run of s-coco detone-orig with ``--feed pool --pool_size 4
  --pool_refresh_steps 2 --steps_per_call 2 --lr 1e-4 --profile`` swaps
  pools, logs ``throughput/pairs_per_sec_per_chip`` and the learning rate
  it was given, and writes a trace of its third block that names the
  program's spans;
* resume through the pool, with swaps inside both epochs and a host prep
  with random crops: one epoch, then the same command with ``--epochs
  2``, gives exactly the losses, weights and records (but the wall-clock
  throughput) of two epochs without a stop.

Every wait on a thread or a queue has a timeout.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bihome_torch import train
from bihome_torch.data import datasets as tds
from bihome_torch.data import pipeline as tpipe
from bihome_torch.data.pack import PackDataset, write_pack
from bihome_torch.training import trainer as ttrainer
from tests.test_torch_host_data import (  # noqa: F401
    cpu_test_env, images, write_jpegs, write_npys)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETONE = 'config/s-coco/detone-orig-lr-5e-3.yaml'
PDS_DETONE = 'config/pds-coco/detone-orig-lr-5e-3.yaml'
CROP = (('Rescale', ((128, 96),)), ('RandomCrop', ((64, 48),)))
WAIT_S = 60


def test_pick_steps_per_call_matches_jax():
    from bihome_tpu.training import trainer as jtrainer
    for steps in range(1, 61):
        for log_step in (1, 2, 7, 10, 12, 64, 100, 1000):
            assert (ttrainer.pick_steps_per_call(steps, log_step)
                    == jtrainer.pick_steps_per_call(steps, log_step)), (
                steps, log_step)


@pytest.mark.parametrize('prep', [(), CROP, 'pack'])
def test_pools_of_an_image_folder_are_jax_pools(prep, tmp_path):
    """'pack': the port's pools of a pack of the folder's images (one
    native gather each) against JAX's pools of the folder."""
    from bihome_tpu.data import datasets as jds
    root = write_jpegs(tmp_path / 'jpg', images(9, 120, 160, 0))
    jdata = jds.ImageFolderDataset(root, (160, 120))
    tdata = tds.ImageFolderDataset(root, (160, 120))
    if prep == 'pack':
        write_pack(str(tmp_path / 'pack.bhpk'),
                   [tdata.load_image(i) for i in range(len(tdata))])
        tdata = PackDataset(str(tmp_path / 'pack.bhpk'))
        assert tdata.native
    elif prep:
        jdata = jds.HostPrepDataset(jdata, prep, random_seed=7)
        tdata = tds.HostPrepDataset(tdata, prep, random_seed=7)
    sampler = jds.EpochSampler(len(jdata), 6, random_seed=7)
    want = [np.stack([jdata.load_image(int(i))
                      for i in sampler.epoch_indices()]) for _ in range(3)]
    source = tds.image_pool_source(tdata, 6, 7)
    got = [source.build(0)]
    refresher = tds.PoolRefresher(source, 1)
    try:
        got += [refresher.get(WAIT_S), refresher.get(WAIT_S)]
    finally:
        refresher.close(WAIT_S)
    assert not refresher._thread.is_alive()
    for k, (a, b) in enumerate(zip(want, got)):
        assert b.dtype == np.uint8 and b.shape[0] == 6, k
        np.testing.assert_array_equal(a, b, err_msg=f'pool {k}')
    source.restore(source.start_states(1))
    np.testing.assert_array_equal(source.build(1), want[1])


@pytest.mark.parametrize('shape', [(5, 6, 8, 3), (4, 2, 6, 8, 3)])
def test_take_images_matches_jax(shape):
    from bihome_tpu.data import pipeline as jpipe
    pool = np.random.RandomState(1).randint(0, 256, shape, dtype=np.uint8)
    idx = np.array([3, 0, 3, 1, 2, 0])
    want = np.asarray(jpipe.take_images(jnp.asarray(pool), jnp.asarray(idx)))
    got = tpipe.take_images(torch.from_numpy(pool), torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


class _Counter:
    """Pools k = 0, 1, ... of three 1x1 images of value k, drawn from a
    RandomState as a sampler would."""

    def __init__(self, fail_at=None):
        self.k = 0
        self.fail_at = fail_at
        self.rs = np.random.RandomState(0)

    def __call__(self):
        if self.k == self.fail_at:
            raise OSError(f'cannot decode pool {self.k}')
        self.rs.randint(10)
        self.k += 1
        return np.full((3, 1, 1, 1), self.k - 1, np.uint8)

    def source(self):
        return tds.PoolSource(self, {'sampler': self.rs})


def _feed(counter, refresh=True, spc=2, refresh_blocks=2):
    feed = train.PoolFeed(counter.source(), None, torch.device('cpu'), spc,
                          refresh_blocks, refresh, 0)
    feed.swap_timeout = WAIT_S
    return feed


@pytest.mark.parametrize('start,swaps', [(0, [4, 9, 12]),
                                          (6, [8, 13, 16, 20])])
def test_swap_schedule(start, swaps):
    """K 2, two blocks a pool (4 steps), epochs of 5 steps (blocks 2, 2,
    1); a resumed run at step 6 starts from pool 1. The refresher hands
    over the source's pools in order."""
    feed = _feed(_Counter())
    feed.start(start)
    first = feed.index
    used, step = [], start
    try:
        for _ in range(3):
            for n in train.blocks_of(5, 2):
                assert int(feed.pool[0]) == feed.index - first
                used.append((step, feed.index))
                step += n
                feed.advance(step)
    finally:
        feed.close()
    assert not feed.refresher._thread.is_alive()
    assert used == [(s, s // 4) for s in
                    np.cumsum([start] + [2, 2, 1] * 3)[:-1].tolist()]
    assert sorted(feed.swaps) == swaps
    still = _feed(_Counter(), refresh=False)
    still.start(start)
    assert still.refresher is None and still.advance(start + 8) == 0.0
    assert still.index == 0 and int(still.pool[0]) == 0


def test_refresher_raises_a_failed_build_and_stops():
    source = _Counter(fail_at=2).source()
    source.build(0)
    refresher = tds.PoolRefresher(source, 1)
    try:
        assert refresher.get(WAIT_S).flat[0] == 1
        with pytest.raises(OSError, match='cannot decode pool 2'):
            refresher.get(WAIT_S)
    finally:
        refresher.close(WAIT_S)
    assert not refresher._thread.is_alive()
    # A thread waiting on its full queue stops when closed.
    full = tds.PoolRefresher(_Counter().source(), 0)
    full.close(WAIT_S)
    assert full._thread.daemon and not full._thread.is_alive()
    # A build that does not end times the wait out.
    release = threading.Event()
    slow = tds.PoolRefresher(tds.PoolSource(
        lambda: release.wait(WAIT_S) and np.zeros(1), {}), 0)
    try:
        with pytest.raises(TimeoutError):
            slow.get(0.3)
    finally:
        release.set()
        slow.close(WAIT_S)
    assert not slow._thread.is_alive()


def _records(log_dir):
    return [json.loads(x) for x in
            (log_dir / 'metrics.jsonl').read_text().splitlines()]


@pytest.mark.usefixtures('cpu_test_env')
def test_cli_pool_flags_log_throughput_and_write_a_trace(tmp_path, capsys):
    log_dir = tmp_path / 'log'
    result = train.main([
        '--config_file', DETONE, '--synthetic', '--steps', '6',
        '--batch_size', '2', '--epochs', '1', '--device', 'cpu',
        '--feed', 'pool', '--pool_size', '4', '--pool_refresh_steps', '2',
        '--steps_per_call', '2', '--lr', '1e-4', '--profile',
        '--set', f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=2'])
    out = capsys.readouterr().out
    assert 'steps_per_call: 2' in out
    assert f'Profile trace written to {log_dir}/profile' in out
    trace = log_dir / 'profile' / 'trace.json'
    assert trace.exists() and 'traceEvents' in json.loads(trace.read_text())
    assert result['profile']['block'] == 2
    # The program's spans name the layers in it: the block's two steps.
    names = [e.get('name') for e in json.loads(trace.read_text())[
        'traceEvents']]
    assert names.count('train.step') == 2
    assert names.count('model.backbone') == 2
    assert sorted(result['swap_ms']) == [2, 4, 6]
    assert len(result['train_feed'].pool) == 4
    assert result['losses'].shape == (6,) and len(result['wait_ms']) == 6
    records = _records(log_dir)
    assert [r['step'] for r in records] == [2, 4, 6, 6]
    assert 'throughput/pairs_per_sec_per_chip' not in records[0]
    for rec in records[1:3]:
        assert rec['throughput/pairs_per_sec_per_chip'] > 0
        assert rec['lr/value'] == pytest.approx(1e-4)
    assert np.isfinite(records[3]['loss/test'])


@pytest.mark.usefixtures('cpu_test_env')
def test_resume_through_the_pool_is_bitwise(tmp_path, capsys):
    """pds-coco detone-orig (the PDS distortion's draws too) with a random
    crop in its host prep, from 6 .npy images through a pool of 4: 3 steps
    an epoch in blocks of 2 and 1, a swap every 2 steps."""
    with open(os.path.join(REPO, PDS_DETONE)) as f:
        config = yaml.safe_load(f)
    config['DATA']['TRANSFORMS'].insert(0, {'RandomCrop': [[216, 288]]})
    path = tmp_path / 'crop.yaml'
    path.write_text(yaml.safe_dump(config))
    split = write_npys(tmp_path / 'npy', images(6, 240, 320, 5))

    def run(log_dir, epochs):
        return train.main([
            '--config_file', str(path), '--steps', '3', '--batch_size', '2',
            '--epochs', str(epochs), '--device', 'cpu', '--pool_size', '4',
            '--pool_refresh_steps', '2', '--steps_per_call', '2',
            '--set', f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=1',
            '--set', f'DATA.TRAIN_SPLIT={split}',
            '--set', f'DATA.TEST_SPLIT={split}'])

    whole = run(tmp_path / 'a', 2)
    assert 'HostPrepDataset' in capsys.readouterr().out
    assert sorted(whole['swap_ms']) == [2, 5, 6]
    first = run(tmp_path / 'b', 1)
    capsys.readouterr()
    resumed = run(tmp_path / 'b', 2)
    out = capsys.readouterr().out
    assert 'Resumed from' in out and 'from their seeds' not in out
    assert resumed['start_step'] == 3 and sorted(resumed['swap_ms']) == [5, 6]
    assert torch.equal(torch.cat([first['losses'], resumed['losses']]),
                       whole['losses'])
    want = whole['model'].state_dict()
    for k, v in resumed['model'].state_dict().items():
        assert torch.equal(v, want[k]), k

    def plain(records):
        return [{k: v for k, v in r.items()
                 if k != 'throughput/pairs_per_sec_per_chip'}
                for r in records]
    assert plain(_records(tmp_path / 'b')) == plain(_records(tmp_path / 'a'))
