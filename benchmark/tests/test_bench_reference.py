"""The plain reference against the program on the CPU at two pairs a step
(the program's kernels run their plain versions here), the weights both
receive, and the program's bfloat16 path failing the same comparison."""

import pytest
import torch

from benchmark.harness import inputs, manifest
from benchmark.reference import step
from benchmark.tests.conftest import run_cell

M = manifest.load()
TRAIN = ['pds-zeng-bihome.train-b64', 'pds-detone-orig.train-b128']
PREDICT = ['pds-zeng-bihome.predict-b64']


@pytest.mark.parametrize('workload', TRAIN + PREDICT)
def test_program_and_reference_agree_on_the_cpu(monkeypatch, workload):
    rc, line = run_cell(monkeypatch, workload)
    assert rc == 0
    assert line['correct'], line['checks']


@pytest.mark.parametrize('workload', TRAIN + PREDICT)
def test_the_bf16_control_fails(monkeypatch, workload):
    rc, line = run_cell(monkeypatch, workload, dtype='bfloat16')
    assert rc == 0
    assert not line['correct'], line['checks']


@pytest.mark.parametrize('config', ['pds-zeng-bihome', 'pds-detone-orig'])
def test_both_sides_get_the_same_weights(config):
    from bihome_torch import config as config_lib
    cfg = manifest.Cell(M, next(w['name'] for w in M['workloads']
                                if w['config'] == config)).config['config']
    prog = config_lib.build_model(cfg).model
    ref = step.build(cfg).model
    inputs.seeded_init(prog, 12345)
    inputs.seeded_init(ref, 12345)
    a, b = prog.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ref2 = step.build(cfg).model
    inputs.seeded_init(ref2, 12346)
    first = next(iter(a))
    assert not torch.equal(ref2.state_dict()[first], b[first])


def test_the_pool_follows_the_seed():
    a = inputs.make_image_pool(3, (24, 32), 7, torch.device('cpu'))
    b = inputs.make_image_pool(3, (24, 32), 7, torch.device('cpu'))
    c = inputs.make_image_pool(3, (24, 32), 8, torch.device('cpu'))
    assert a.dtype == torch.uint8 and a.shape == (3, 24, 32, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) == 0 and int(a.max()) >= 250
    assert inputs.sub_seed(2 ** 31 + 5, 1) < 2 ** 63
    assert inputs.sub_seed(1, 1) != inputs.sub_seed(2, 1)
