"""The port's train and eval entry points on the CPU for the PDS-COCO
configs with a regression backbone (detone-orig, nguyen-orig and
zhang-orig), and eval on the ResNet34 configs: the tests of
tests/test_torch_cli_pds.py on their share of the configs (that file
holds the biHomE-loss configs; the two were one file, the slowest of
the whole test run).
"""

import numpy as np
import pytest

from tests import test_torch_cli_pds as cli
from tests.torch_threads import one_torch_thread  # noqa: F401

PDS = ('detone-orig-lr-5e-3', 'nguyen-orig-lr-5e-3', 'zhang-orig-lr-1e-2')


@pytest.mark.parametrize('name', PDS)
def test_train_cli_runs_pds_config_on_cpu(name, tmp_path):
    cli.check_train_cli(name, tmp_path)


@pytest.mark.parametrize('config', [
    'config/pds-coco/detone-orig-lr-5e-3.yaml',
    'config/pds-coco/nguyen-orig-lr-5e-3.yaml',
    'config/s-coco/nguyen-orig-lr-5e-3.yaml'])
def test_eval_cli_runs_resnet34_config_on_cpu(config):
    lines = cli._eval(config)
    assert int(lines['Number of params']) == 21_285_640
    assert np.isfinite(float(lines['Mean mace']))
    assert float(lines['Mean model time']) > 0
