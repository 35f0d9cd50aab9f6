"""TensorBoard events of the port's metrics writer
(``bihome_torch/training/metrics.py``), behind BIHOME_TENSORBOARD as in
``bihome_tpu/training/metrics.py:22-59``.

* With the variable set, every scalar of every ``scalars`` call reads back
  from the event file (tensorboard's ``EventAccumulator``) at its step,
  equal to its ``metrics.jsonl`` record (each value is a float32 there
  and in the event); the train entry point writes them beside its JSONL.
* Unset, or on a rank other than 0 (``make_writer``: a ``NullWriter``),
  no event file is written.
* Where ``torch.utils.tensorboard`` cannot be imported, the writer writes
  the JSONL alone and says so in one line on stderr.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from bihome_torch.training import metrics


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while this file runs: its CPU work is
    small, and the parallel test run's workers then do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()['scalars']}


def _records(log_dir):
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _event_files(log_dir):
    return [n for n in os.listdir(log_dir) if n.startswith('events.')]


def _assert_events_equal_records(log_dir):
    events = _events(log_dir)
    records = _records(log_dir)
    want = {}
    for rec in records:
        for key, value in rec.items():
            if key != 'step':
                want.setdefault(key, []).append((rec['step'], value))
    assert set(events) == set(want)
    for key, rows in want.items():
        assert [s for s, _ in events[key]] == [s for s, _ in rows], key
        np.testing.assert_array_equal(
            np.float32([v for _, v in events[key]]),
            np.float32([v for _, v in rows]), err_msg=key)


def test_events_read_back_equal_to_the_jsonl(tmp_path, monkeypatch):
    monkeypatch.setenv('BIHOME_TENSORBOARD', '1')
    writer = metrics.make_writer(str(tmp_path), 0)
    writer.scalars(1, {'loss/train': torch.tensor(0.123456789),
                       'g_norm/value': 3.5, 'lr/value': np.float32(1e-3)})
    writer.scalars(2, {'loss/train': torch.tensor(-2.5e-7),
                       'mace/train': torch.tensor(12.75)})
    writer.flush()
    writer.close()
    assert len(_event_files(str(tmp_path))) == 1
    _assert_events_equal_records(str(tmp_path))


@pytest.mark.parametrize('case', ['unset', 'rank 1'])
def test_no_events_unset_or_off_rank_0(tmp_path, monkeypatch, case):
    if case == 'unset':
        monkeypatch.delenv('BIHOME_TENSORBOARD', raising=False)
        writer = metrics.make_writer(str(tmp_path), 0)
    else:
        monkeypatch.setenv('BIHOME_TENSORBOARD', '1')
        writer = metrics.make_writer(str(tmp_path), 1)
        assert isinstance(writer, metrics.NullWriter)
    writer.scalars(1, {'loss/train': 1.0})
    writer.flush()
    writer.close()
    assert _event_files(str(tmp_path)) == []
    assert os.listdir(tmp_path) == ([] if case == 'rank 1'
                                    else ['metrics.jsonl'])


def test_missing_tensorboard_drops_events_and_says_so(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setenv('BIHOME_TENSORBOARD', '1')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    writer = metrics.make_writer(str(tmp_path), 0)
    writer.scalars(3, {'loss/train': 0.5})
    writer.close()
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and 'BIHOME_TENSORBOARD' in err[0]
    assert os.listdir(tmp_path) == ['metrics.jsonl']
    assert _records(str(tmp_path)) == [{'step': 3, 'loss/train': 0.5}]


def test_train_cli_writes_events_beside_the_jsonl(tmp_path, monkeypatch):
    from bihome_torch import train
    monkeypatch.setenv('BIHOME_TENSORBOARD', '1')
    log_dir = str(tmp_path / 'log')
    train.main(['--config_file', 'config/s-coco/detone-orig-lr-5e-3.yaml',
                '--synthetic', '--steps', '2', '--batch_size', '2',
                '--epochs', '1', '--device', 'cpu', '--set',
                f'LOGGING.DIR={log_dir}', '--set', 'LOGGING.STEP=1'])
    assert len(_records(log_dir)) == 3          # two steps and the test pass
    _assert_events_equal_records(log_dir)
