"""The port stands alone: no module of bihome_torch, nor chip_smoke.py,
imports jax, flax, optax or the JAX package, directly (checked on the
source with ast) or through another module (checked by importing every
module in a subprocess where those imports are blocked)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'bihome_tpu')
SOURCES = sorted(REPO.glob('bihome_torch/**/*.py')) + [REPO / 'chip_smoke.py']


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path.relative_to(REPO)} imports {bad}'


_BLOCKED_IMPORT = '''
import importlib, pkgutil, sys
FORBIDDEN = {forbidden!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError('blocked import of ' + name)
        return None

sys.meta_path.insert(0, Block())
import bihome_torch
names = [m.name for m in pkgutil.walk_packages(bihome_torch.__path__,
                                                'bihome_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
import bihome_torch.eval
print(len(names))
'''


# The modules of the later slices (PDS / ResNet34; zeng-orig's RANSAC and
# CLEVR-Change; the host data path, checkpoints and the torchvision
# grafts), each checked by name so that a rename cannot drop it from
# the checks above unnoticed.
SLICE_MODULES = ('bihome_torch/data/photometric.py',
                 'bihome_torch/ops/color.py',
                 'bihome_torch/data/pipeline.py',
                 'bihome_torch/models/backbones.py',
                 'bihome_torch/models/resnet.py',
                 'bihome_torch/heads/assembled.py',
                 'bihome_torch/training/losses.py',
                 'bihome_torch/heads/ransac.py',
                 'bihome_torch/data/clevr_change.py',
                 'bihome_torch/train.py',
                 'bihome_torch/eval.py',
                 'bihome_torch/data/datasets.py',
                 'bihome_torch/data/transforms_host.py',
                 'bihome_torch/data/cifar10.py',
                 'bihome_torch/data/pack.py',
                 'bihome_torch/training/checkpoint.py',
                 'bihome_torch/training/train_state.py',
                 'bihome_torch/models/torchvision_port.py',
                 'bihome_torch/preprocess_offline.py')


@pytest.mark.parametrize('rel', SLICE_MODULES)
def test_slice_module_is_checked_and_imports_with_jax_blocked(rel):
    assert REPO / rel in SOURCES
    module = rel[:-3].replace('/', '.')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = _BLOCKED_IMPORT.split('import bihome_torch')[0] + (
        f'import importlib; importlib.import_module({module!r}); print(1)')
    proc = subprocess.run(
        [sys.executable, '-c', code.format(forbidden=FORBIDDEN)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKED_IMPORT.format(forbidden=FORBIDDEN)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
