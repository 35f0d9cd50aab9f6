"""A whole training step and the predict chain of the zhang family
(pds-coco/zhang-orig: the ContentAware backbone under FIX_MASK, the
TripletHead, SOLVER.LOSS TripletLoss) against the JAX package, as
tests/test_torch_train_resnet34.py does for the ResNet34 family.

Cut to 64x64 patches, rho 8, batch 4 and 96x96 synthetic images, full
width, DoubleLine: injected pair draws (the JAX photometric draws derived
from the JAX keys; both copies distorted) -> backbone in training mode
(mask ones, the feature extractor on both patches, the ResNet34 regressor
on both orders) -> the TripletHead (both patches warped by the predicted
deltas, the extractor re-run on each, the fused tail, the MU term) ->
backward. The JAX side is the ``loss_fn`` of
``bihome_tpu/training/trainer.py:62-79`` under ``jax.value_and_grad``;
the port side is ``bihome_torch.training.trainer.train_step``. Backbone
weights: the JAX init with random BN statistics and affines, the
regressor's last BN of each block scaled by 1/4.

Tolerances, those of tests/test_torch_train_resnet34.py: loss and metrics
rtol 1e-3; the new BN statistics (the extractor's after its three
updates) 1e-4; gradients each tensor within 3e-2 relative L2 of JAX's and
the median over tensors of (largest difference / largest entry) within
1e-2. The predict chain (eval-mode backbone on the test spec's pairs):
delta_hat and MACE within 1e-2 px.
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
from tests.test_torch_train_resnet34 import BATCH, _pairs, _small_config

CONFIG = 'config/pds-coco/zhang-orig-lr-1e-2.yaml'


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


@pytest.fixture(scope='module')
def step_outputs():
    jconf = _small_config(jconfig, CONFIG)
    built = jconfig.build_model(jconf)
    images, corners, delta = _pairs(seed=4)
    k1 = jax.random.split(jax.random.PRNGKey(41), BATCH)
    k2 = jax.random.split(jax.random.PRNGKey(42), BATCH)
    batch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                  jnp.asarray(delta), k1, k2,
                                  built.pair_spec)
    variables = _variables(built, batch, seed=9)

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
                'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat']),
                **out['metrics']}

    tbuilt = tconfig.build_model(_small_config(tconfig, CONFIG))
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


def test_zhang_step_loss_and_metrics_match_jax(step_outputs):
    want, got = step_outputs['jax_metrics'], step_outputs['port_metrics']
    assert set(got) == set(want)
    assert np.isfinite(got['loss/train'])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-5,
                                   err_msg=key)


def test_zhang_step_gradients_match_jax(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': {'backbone': step_outputs['jax']['grads']}})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    assert any(k.startswith('backbone.feature_extractor') for k in want)
    rel_max = []
    for name, want_g in want.items():
        got = params[name].grad
        l2 = float((got - want_g).norm() / want_g.norm())
        assert l2 < 3e-2, (name, l2)
        rel_max.append(float((got - want_g).abs().max() / want_g.abs().max()))
    assert np.median(rel_max) < 1e-2, np.median(rel_max)


def test_zhang_step_batch_stats(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': {'backbone': {}},
         'batch_stats': step_outputs['jax']['stats']})
    buffers = dict(model.named_buffers())
    assert len(want) == 2 * (36 + 3)
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert int(buffers['backbone.feature_extractor.layer1.1.'
                       'num_batches_tracked']) == 3


def test_zhang_predict_chain_matches_jax():
    built = jconfig.build_model(_small_config(jconfig, CONFIG))
    images, corners, delta = _pairs(seed=10)
    k1 = jax.random.split(jax.random.PRNGKey(51), BATCH)
    k2 = jax.random.split(jax.random.PRNGKey(52), BATCH)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), k1, k2,
                                   built.test_pair_spec)
    variables = _variables(built, jbatch, seed=11)
    want, _ = built.model.apply(variables, jbatch,
                                method=built.model.predict)
    mace_j = float(jgeo.mace(jbatch['delta'], want))

    tbuilt = tconfig.build_model(_small_config(tconfig, CONFIG))
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
