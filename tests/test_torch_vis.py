"""Eval visualization in the port (``bihome_torch/utils/visualization.py``
and ``bihome_torch.eval --vis``) against the JAX package's
(``bihome_tpu/utils/visualization.py``, ``eval.py:46-100``), on the CPU.

* ``draw_rect`` gives the same array as JAX's (quadrilaterals partly
  outside the image, each colour), and ``save_gif`` writes the same bytes.
* ``save_visualization`` of the same arrays (two samples, with image_2 and
  a perspective field) writes the same file names with the same bytes as
  JAX's ``eval.save_visualization``.
* ``bihome_torch.eval --vis`` on S-COCO zeng-biHomE (synthetic images,
  batch 2, one step) writes that set of files for each sample, its
  ``image_2`` the whole 240x320 frame.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bihome_tpu.utils import visualization as jvis
from bihome_torch import eval as teval
from bihome_torch.utils import visualization as tvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ('image_vis.png', 'patch_1_2_mask.gif', 'warped.npy', 'patch_2.npy',
         'mask_1.npy', 'mask_2.npy', 'pf.npy')


def _jax_eval():
    """The JAX eval entry point as a module (``eval.py`` at the root)."""
    spec = importlib.util.spec_from_file_location(
        'jax_eval_cli', os.path.join(REPO, 'eval.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('color', ['r', 'g', 'b'])
def test_draw_rect_matches_jax(color):
    rs = np.random.RandomState(0)
    image = rs.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    for corners in (rs.uniform(-10, 60, (4, 2)),
                    np.array([[5.5, 4.2], [44.9, 3.1], [47.0, 35.5],
                              [2.0, 38.7]])):
        want = jvis.draw_rect(image, corners, color)
        got = tvis.draw_rect(image, corners, color)
        np.testing.assert_array_equal(got, want)
        assert (got != image).any()
    np.testing.assert_array_equal(
        tvis.draw_rect(image, corners, color, thickness=4),
        jvis.draw_rect(image, corners, color, thickness=4))


def test_save_gif_writes_jax_bytes(tmp_path):
    rs = np.random.RandomState(1)
    frames = [rs.randint(0, 256, (16, 16, 3)).astype(np.uint8),
              rs.randint(0, 256, (16, 16, 1)).astype(np.uint8)]
    jvis.save_gif(str(tmp_path / 'jax.gif'), frames, duration=0.3)
    tvis.save_gif(str(tmp_path / 'port.gif'), frames, duration=0.3)
    assert (tmp_path / 'port.gif').read_bytes() == \
        (tmp_path / 'jax.gif').read_bytes()


def _vis_batch(b=2, ps=16, seed=2):
    rs = np.random.RandomState(seed)
    corners = np.array([[8, 6], [24, 6], [24, 22], [8, 22]], np.float32)
    return {'warped': rs.randn(b, ps, ps, 1).astype(np.float32),
            'mask_1_warped': rs.uniform(0, 1.2, (b, ps, ps, 1)).astype(
                np.float32),
            'mask_2': np.ones((b, ps, ps, 1), np.float32),
            'patch_2': rs.randn(b, ps, ps, 1).astype(np.float32),
            'corners': np.broadcast_to(corners, (b, 4, 2)).copy(),
            'delta': rs.uniform(-4, 4, (b, 4, 2)).astype(np.float32),
            'delta_hat': rs.uniform(-4, 4, (b, 4, 2)).astype(np.float32),
            'image_2': rs.uniform(-20, 280, (b, 30, 40, 3)).astype(
                np.float32),
            'pf': rs.randn(b, ps, ps, 2).astype(np.float32)}


def test_save_visualization_writes_jax_files(tmp_path):
    batch = _vis_batch()
    _jax_eval().save_visualization(str(tmp_path / 'jax'), 3, 2, batch)
    teval.save_visualization(str(tmp_path / 'port'), 3, 2, batch)
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(f'{n:05d}_{name}' for n in (6, 7)
                           for name in NAMES)
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for name in names:
        assert (tmp_path / 'port' / name).read_bytes() == \
            (tmp_path / 'jax' / name).read_bytes(), name


def test_eval_cli_vis_writes_the_files(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    vis_dir = tmp_path / 'vis'
    proc = subprocess.run(
        [sys.executable, '-m', 'bihome_torch.eval', '--config_file',
         'config/s-coco/zeng-bihome-lr-1e-3.yaml', '--device', 'cpu',
         '--synthetic', '--steps', '1', '--batch_size', '2', '--skip_timing',
         '--vis', '--vis_dir', str(vis_dir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'Visualization artifacts for 2 samples' in proc.stdout
    assert sorted(os.listdir(vis_dir)) == sorted(
        f'{n:05d}_{name}' for n in (0, 1) for name in NAMES)
    assert np.load(vis_dir / '00000_pf.npy').shape == (128, 128, 2)
    from PIL import Image
    with Image.open(vis_dir / '00001_image_vis.png') as img:
        assert img.size == (320, 240)
    torch.testing.assert_close(
        torch.from_numpy(np.load(vis_dir / '00000_mask_2.npy')),
        torch.ones(128, 128, 1))
