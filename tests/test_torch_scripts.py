"""The port's training-quality scripts (``bihome_torch/scripts/*.sh``).

* Every ``python -m bihome_torch.<entry>`` command in them (continuation
  lines joined, the scripts' variables at their defaults) parses under
  that entry point's own parser.
* ``run_family_grid.sh`` runs every family it is given and exits 1 when
  one fails, naming it (JAX's ``tools/run_family_grid.sh:55`` exits 0):
  checked with a stub interpreter (``PYTHON``) whose train step fails for
  one config.
"""

import importlib
import os
import re
import shlex
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'bihome_torch', 'scripts')
NAMES = ('run_family_grid.sh', 'run_pds_demo.sh', 'run_scoco_demo.sh',
         'sweep_pds_predict.sh')
ENV = {'PYTHON': 'python', 'DEVICE': 'cuda', 'EPOCHS': '5', 'AUX': 'a.npz',
       'LOGDIR': 'log/x', 'MARGIN': '0.02', 'SEED': '42', 'OUT_LAYER': '1',
       'CFG': 'config/pds-coco/zeng-bihome-lr-1e-3.yaml', 'CKPT': 'log/x',
       'config': 'config/s-coco/detone-orig-lr-5e-3.yaml', 'logdir': 'log/x',
       'LOG_ROOT': 'log',
       'thr': '2.0', 'R': '--set MODEL.HEAD.DSAC_PREDICT_REFINE=true',
       'B': '--set MODEL.HEAD.DSAC_PREDICT_BIDIRECTIONAL=true'}


def _commands(name):
    """(entry module, argument list) of each ``-m bihome_torch.X`` line."""
    with open(os.path.join(SCRIPTS, name)) as f:
        text = f.read().replace('\\\n', ' ')
    out = []
    for line in text.splitlines():
        m = re.search(r'-m (bihome_torch\.\w+)(.*)', line)
        if not m:
            continue
        rest = re.sub(r'\s*(;;|\|\|.*|\|.*|>.*|2>&1.*)$', '', m.group(2))
        rest = rest.replace('"$@"', '')
        for key, value in ENV.items():
            rest = rest.replace(f'${{{key}}}', value).replace(f'${key}',
                                                              value)
        assert '$' not in rest, (name, rest)
        out.append((m.group(1), shlex.split(rest)))
    return out


@pytest.mark.parametrize('name', NAMES)
def test_every_command_parses_under_its_entry_point(name):
    commands = _commands(name)
    assert commands
    for module, argv in commands:
        args = importlib.import_module(module).parse_args(argv)
        assert args.device == 'cuda', (module, argv)


def test_family_grid_fails_loudly(tmp_path):
    stub = tmp_path / 'python'
    stub.write_text('#!/usr/bin/env bash\n'
                    '# a train run of nguyen fails; everything else works\n'
                    'if [[ "$*" == *bihome_torch.train*nguyen* ]]; then\n'
                    '  exit 3\nfi\necho "Mean mace: 1.0"\n')
    stub.chmod(0o755)
    env = dict(os.environ, PYTHON=str(stub), TARGET='1',
               LOG_ROOT=str(tmp_path / 'log'))
    run = subprocess.run(
        ['bash', os.path.join(SCRIPTS, 'run_family_grid.sh'), 'detone',
         'nguyen', 'zhang'], env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 1, run.stdout + run.stderr
    assert 'failed families: nguyen' in run.stderr
    # The families after the failed one still ran.
    assert '=== zhang-orig: eval at the final checkpoint ===' in run.stdout
    ok = subprocess.run(
        ['bash', os.path.join(SCRIPTS, 'run_family_grid.sh'), 'detone'],
        env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr

