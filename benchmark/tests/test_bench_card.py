"""On the card, at a size a test run holds (eight pairs a step or a
call): a sound run of each cell passes its check, and the TF32 control
(``harness/control.py``) fails it, judged by the cell's own limits. Skips
without a card."""

import pytest

from benchmark.harness import checks, control, manifest
from benchmark.tests.conftest import SMALL, run_cell

CELLS = ['pds-zeng-bihome.train-b64', 'pds-detone-orig.train-b128',
         'pds-zeng-bihome.predict-b64']
EIGHT = dict(SMALL, batch=8, pool_size=64)


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_sound_on_the_card(card, monkeypatch, workload):
    monkeypatch.setitem(SMALL, 'batch', 8)
    monkeypatch.setitem(SMALL, 'pool_size', 64)
    rc, line = run_cell(monkeypatch, workload, device=card)
    assert rc == 0 and line['correct'], line['checks']


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [2 ** 31 + 3, 2 ** 31 + 7, 2 ** 31 + 9])
@pytest.mark.parametrize('workload', CELLS)
def test_the_tf32_control_fails_on_the_card(card, workload, seed):
    cell = manifest.Cell(manifest.load(), workload)
    traffic = dict(cell.traffic, **EIGHT)
    ctx = control.KINDS[traffic['kind']](cell.config, traffic, seed, card)
    assert not checks.passed(checks.judge(ctx['numbers'], cell.limits)), \
        ctx['numbers']
