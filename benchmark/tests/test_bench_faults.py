"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program, at two pairs a step on the
CPU, judged by the cell's own limits (``benchmark/limits``)."""

import pytest

from benchmark.tests.conftest import run_cell

TRAIN = ['pds-zeng-bihome.train-b64', 'pds-detone-orig.train-b128']
CASES = ([(w, f) for w in TRAIN
          for f in ('unchanged', 'half_batch', 'altered')]
         + [('pds-zeng-bihome.predict-b64', f)
            for f in ('half_batch', 'altered')])


@pytest.mark.parametrize('workload,fault', CASES)
def test_a_fault_is_not_correct(monkeypatch, workload, fault):
    rc, line = run_cell(monkeypatch, workload, fault=fault)
    assert rc == 0
    assert not line['correct'], (fault, line['checks'])
