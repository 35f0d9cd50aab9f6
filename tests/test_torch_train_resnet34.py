"""Whole training steps and the predict chain of the ResNet34 regression
family against the JAX package, as tests/test_torch_train_step.py does for
zeng-biHomE.

One step of each of
* pds-coco/detone-orig (NoOpHead, MSELoss; both copies photometrically
  distorted),
* pds-coco/nguyen-orig (NoOpHead, L1Loss; the 'all_points' target made
  and not read; distorted),
* s-coco/nguyen-orig (PhotometricHead, L1Loss on the warp-then-crop of
  the full image_1),
each cut to 64x64 patches, rho 8, batch 4 and 96x96 synthetic images,
OneLine ResNet34Backbone at full width: injected pair draws (the JAX
photometric draws derived from the JAX keys) -> backbone in training mode
-> head -> SOLVER.LOSS -> backward. The JAX side is the ``loss_fn`` of
``bihome_tpu/training/trainer.py:62-79`` under ``jax.value_and_grad``; the
port side is ``bihome_torch.training.trainer.train_step``. Backbone
weights: the JAX init with random BN statistics and affines, the last BN
of each block scaled by 1/4 (tests/test_torch_resnet34.py).

Tolerances, those of tests/test_torch_train_step.py: loss and metrics
rtol 1e-3; the new BN statistics 1e-4; gradients each tensor within 3e-2
relative L2 of JAX's and the median over tensors of (largest difference /
largest entry) within 1e-2 (a ReLU input within float32 rounding of its
kink may take another subgradient on each side).

The predict chain of pds-coco/detone-orig (eval-mode backbone on the test
spec's pairs): delta_hat and MACE within 1e-2 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu import geometry as jgeo
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.data import synthetic as jsyn
from bihome_tpu.training import losses as jlosses
from bihome_tpu.training import train_state as jts
from bihome_torch import config as tconfig
from bihome_torch import geometry as tgeo
from bihome_torch.data import pipeline as tpipe
from bihome_torch.models import weights
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_photometric import jax_photometric_params

CONFIGS = ('config/pds-coco/detone-orig-lr-5e-3.yaml',
           'config/pds-coco/nguyen-orig-lr-5e-3.yaml',
           'config/s-coco/nguyen-orig-lr-5e-3.yaml')
BATCH, PS, RHO, IMG = 4, 64, 8, 96


def _small_config(module, path):
    config = module.load_config(path)
    for key in ('TRANSFORMS', 'TEST_TRANSFORM'):
        config['DATA'][key][0]['HomographyNetPrep'][:2] = [RHO, PS]
    return config


def _pairs(seed):
    """uint8-valued float images [B,96,96,3], integer corners and deltas."""
    rs = np.random.RandomState(seed)
    images = jsyn.make_image_pool(BATCH, IMG, IMG, seed=seed).astype(
        np.float32)
    half = PS // 2
    pos = rs.randint(RHO + half, IMG - RHO - half + 1, (BATCH, 2))
    corners = np.stack([pos - half, pos + [half, -half], pos + half,
                        pos + [-half, half]], 1).astype(np.int32)
    delta = rs.randint(-RHO, RHO, (BATCH, 4, 2)).astype(np.int32)
    return images, corners, delta


def _variables(built, batch, seed):
    variables = jax.jit(built.model.init)({'params': jax.random.PRNGKey(0)},
                                          batch)
    rs = np.random.RandomState(seed)
    backbone = randomize_variables({c: variables[c]['backbone']
                                    for c in ('params', 'batch_stats')}, rs)
    for name, block in backbone['params']['resnet34'].items():
        if name.startswith('layer'):
            block['bn2']['scale'] = block['bn2']['scale'] * 0.25
    return {c: {'backbone': backbone[c]} for c in ('params', 'batch_stats')}


@pytest.fixture(scope='module', params=CONFIGS,
                ids=[p.split('config/')[1] for p in CONFIGS])
def step_outputs(request):
    path = request.param
    jconf = _small_config(jconfig, path)
    built = jconfig.build_model(jconf)
    assert not built.needs_dsac_rng
    images, corners, delta = _pairs(seed=3)
    k1 = jax.random.split(jax.random.PRNGKey(21), BATCH)
    k2 = jax.random.split(jax.random.PRNGKey(22), BATCH)
    batch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                  jnp.asarray(delta), k1, k2,
                                  built.pair_spec)
    variables = _variables(built, batch, seed=5)

    def loss_fn(params):
        out, mutated = built.model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch, train=True, rngs=None, mutable=['batch_stats'])
        return jlosses.compute_loss(built.loss_name, out), (out, mutated)

    (loss, (out, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    _, schedule = jts.make_optimizer(**jconfig.solver_kwargs(jconf))
    jmetrics = {'loss/train': loss, 'g_norm/value': optax.global_norm(grads),
                'lr/value': schedule(0),
                'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat'])}

    tbuilt = tconfig.build_model(_small_config(tconfig, path))
    assert tbuilt.pair_spec.emit_images == built.pair_spec.emit_images
    model = tbuilt.model
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(tbuilt.config))
    pds = (jax_photometric_params(k1), jax_photometric_params(k2))
    tmetrics = trainer.train_step(
        model, opt, torch.from_numpy(images).to(torch.uint8),
        tbuilt.pair_spec, tbuilt.loss_name,
        corners=torch.from_numpy(corners), delta=torch.from_numpy(delta),
        photometric_params=pds)
    to_np = jax.tree_util.tree_map(np.asarray, {
        'grads': grads['backbone'], 'stats': mutated['batch_stats']})
    return {'jax_metrics': {k: float(v) for k, v in jmetrics.items()},
            'port_metrics': {k: float(v) for k, v in tmetrics.items()},
            'jax': to_np, 'model': model}


def test_train_step_loss_and_metrics_match_jax(step_outputs):
    want, got = step_outputs['jax_metrics'], step_outputs['port_metrics']
    assert set(got) == set(want)
    assert np.isfinite(got['loss/train'])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-5,
                                   err_msg=key)


def test_train_step_gradients_match_jax(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': step_outputs['jax']['grads']})
    params = dict(model.backbone.named_parameters())
    assert set(want) == set(params)
    rel_max = []
    for name, want_g in want.items():
        got = params[name].grad
        l2 = float((got - want_g).norm() / want_g.norm())
        assert l2 < 3e-2, (name, l2)
        rel_max.append(float((got - want_g).abs().max() / want_g.abs().max()))
    assert np.median(rel_max) < 1e-2, np.median(rel_max)


def test_train_step_batch_stats(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': {'backbone': {}},
         'batch_stats': step_outputs['jax']['stats']})
    buffers = dict(model.named_buffers())
    assert len(want) == 2 * 36
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_detone_predict_chain_matches_jax():
    path = CONFIGS[0]
    built = jconfig.build_model(_small_config(jconfig, path))
    images, corners, delta = _pairs(seed=8)
    k1 = jax.random.split(jax.random.PRNGKey(31), BATCH)
    k2 = jax.random.split(jax.random.PRNGKey(32), BATCH)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), k1, k2,
                                   built.test_pair_spec)
    variables = _variables(built, jbatch, seed=6)
    want, _ = built.model.apply(variables, jbatch,
                                method=built.model.predict)
    mace_j = float(jgeo.mace(jbatch['delta'], want))

    tbuilt = tconfig.build_model(_small_config(tconfig, path))
    model = tbuilt.model
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    tbatch = tpipe._assemble_pairs(
        torch.from_numpy(images), torch.from_numpy(corners).long(),
        torch.from_numpy(delta).long(), tbuilt.test_pair_spec,
        jax_photometric_params(k1), jax_photometric_params(k2))
    got = model.eval().predict(tbatch)
    assert got.shape == (BATCH, 4, 2)
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-2)
    mace_t = float(tgeo.mace(tbatch['delta'], got))
    assert np.isfinite(mace_t) and abs(mace_t - mace_j) < 1e-2
