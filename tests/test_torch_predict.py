"""The whole predict slice of the port against the JAX chain.

Images -> injected pair synthesis -> Rethinking DoubleLine backbone ->
DSAC (one hypothesis of 128 points, the JAX uniforms injected) -> corner
deltas -> MACE. The JAX side is ``backbone.apply(train=False)`` ->
``dsac.sample_hypotheses_from_pf(key)`` -> the corner transform of
``heads/assembled.py:391-395``.

Small size: 64x64 images, 32x32 patches, rho 8, batch 2; JAX weights
carried across. The PF head's last conv is scaled so the random field is a
few pixels, the size of a trained model's output and of the corner
perturbations. Tolerance on delta_hat and MACE: 1e-2 px (the backbone
agrees to ~1e-4 relative; the DLT over 128 points amplifies that).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import geometry as jgeo
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import dsac as jdsac
from bihome_torch import geometry as tgeo
from bihome_torch.config import build_model, load_config
from bihome_torch.data import pipeline as tpipe
from bihome_torch.heads.assembled import AssembledModel
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models import weights
from bihome_torch.models.backbones import RethinkingBackbone
from tests.test_torch_backbone import KEYS, jax_backbone, randomize_variables
from tests.test_torch_datagen import ZENG, _injected, _small_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PF_SCALE = 0.03


@pytest.fixture(scope='module')
def slice_outputs():
    images, corners, delta = _injected(seed=4)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), keys, keys,
                                   _small_spec(jpipe))
    rs = np.random.RandomState(1)
    variables = randomize_variables(
        jax_backbone().init(jax.random.PRNGKey(0), jbatch), rs)
    for name in ('conv2_kernel', 'conv2_bias'):
        variables['params']['layer8'][name] *= PF_SCALE
    pf = jax_backbone().apply(variables, jbatch, train=False)[KEYS[0]]
    key = jax.random.PRNGKey(7)
    hyps = jdsac.sample_hypotheses_from_pf(pf, key, 1, 128,
                                           'reference-weighted')
    fp = jnp.broadcast_to(jnp.array([[0, 0], [32, 0], [32, 32], [0, 32]],
                                    jnp.float32)[None], (2, 4, 2))
    want = jgeo.transform_points(hyps.reshape(-1, 3, 3), fp) - fp
    uniforms = np.array(jax.random.uniform(key, (2, 128), jnp.float32))

    head = HeadConfig.from_yaml(load_config(ZENG[0])['MODEL']['HEAD'])
    model = AssembledModel(
        RethinkingBackbone(target_keys=KEYS, variant='doubleline'), head)
    weights.load_state_dict(model.backbone,
                            weights.state_dict_from_jax(variables))
    model.eval()
    tbatch = tpipe._assemble_pairs(torch.from_numpy(images),
                                   torch.from_numpy(corners).long(),
                                   torch.from_numpy(delta).long(),
                                   _small_spec(tpipe))
    got = model.predict(tbatch, uniforms=torch.from_numpy(uniforms))
    return (got.numpy(), np.asarray(want), tbatch['delta'],
            jbatch['delta'], np.asarray(pf))


def test_predict_delta_hat_matches_jax_chain(slice_outputs):
    got, want, _, _, pf = slice_outputs
    assert 0.5 < np.abs(pf).mean() < 20.0, 'PF should be a few pixels'
    assert got.shape == (2, 4, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_predict_mace_matches_jax_chain(slice_outputs):
    got, want, tdelta, jdelta, _ = slice_outputs
    mace_t = float(tgeo.mace(tdelta, torch.from_numpy(got)))
    mace_j = float(jgeo.mace(jdelta, jnp.asarray(want)))
    assert np.isfinite(mace_t)
    assert abs(mace_t - mace_j) < 1e-2


def test_build_model_refuses_unported_families():
    config = load_config(ZENG[0])
    config['MODEL']['HEAD']['RANSAC_HYPOTHESIS_NO'] = 2
    with pytest.raises(ValueError, match='not ported yet'):
        build_model(config)


def test_eval_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run(
        [sys.executable, '-m', 'bihome_torch.eval', '--config_file', ZENG[0],
         '--device', 'cpu', '--synthetic', '--steps', '1', '--batch_size',
         '2'], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(': ', 1) for line in proc.stdout.splitlines()
                 if ': ' in line)
    assert int(lines['Number of params']) == 10_574_178
    assert np.isfinite(float(lines['Mean mace']))
    assert float(lines['Mean model time']) > 0


def test_eval_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from bihome_torch import eval as teval
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        teval.main(['--config_file', ZENG[0], '--synthetic', '--steps', '1'])
