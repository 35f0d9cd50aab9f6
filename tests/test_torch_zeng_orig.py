"""zeng-orig (Zeng et al.'s perspective-field network: the OneLine
Rethinking ResNet34 backbone, the NoOp 'all_points' head, SmoothL1 on the
PF target, RANSAC at predict) against the JAX package.

Cut to 32x32 patches, rho 8, batch 2 and 64x64 synthetic images, full
width. Backbone weights: the JAX init with random BN statistics and
affines, the last BN of each residual branch scaled by 1/4 and the PF
head's output conv scaled so the field is a few pixels (the conditioning
of tests/test_torch_train_step.py).

* S-COCO, eval mode, the PF head's output conv unscaled (a field of a few
  pixels in eval mode): the training forward (the PF target, the field,
  the corner readout delta_hat within 1e-4; the SmoothL1 loss rtol 1e-4),
  and predict, the RANSAC fit of the field, against JAX's postprocess of
  its own field (``assembled.py:774-776``) with the JAX draws injected
  (``jax.random.randint`` returns them in the eager JAX call): delta_hat
  and MACE within 1e-2 px (the backbone's ~1e-4 relative differences
  through the DLT refit).
* One whole training step of pds-coco/zeng-orig (the JAX photometric draws
  derived from the JAX keys), the family's one whole-step test: the
  tolerances of tests/test_torch_train_step.py (loss and metrics rtol
  1e-3; BN statistics 1e-4; gradients each tensor within 3e-2 relative L2
  and the median of (largest difference / largest entry) within 1e-2).
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
from bihome_tpu.heads import ransac as jransac
from bihome_tpu.training import losses as jlosses
from bihome_tpu.training import train_state as jts
from bihome_torch import config as tconfig
from bihome_torch import geometry as tgeo
from bihome_torch.data import pipeline as tpipe
from bihome_torch.heads import ransac as transac
from bihome_torch.models import weights
from bihome_torch.training import losses as tlosses
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_datagen import _injected
from tests.test_torch_photometric import jax_photometric_params

CONFIGS = ('config/s-coco/zeng-orig-lr-1e-3.yaml',
           'config/pds-coco/zeng-orig-lr-1e-3.yaml')
BATCH = 2
PF_SCALE = 0.03


def _small_config(module, path):
    config = module.load_config(path)
    for key in ('TRANSFORMS', 'TEST_TRANSFORM'):
        config['DATA'][key][0]['HomographyNetPrep'][:2] = [8, 32]
    return config


def _variables(built, batch, seed, pf_scale=PF_SCALE):
    variables = jax.jit(built.model.init)({'params': jax.random.PRNGKey(0)},
                                          batch)
    rs = np.random.RandomState(seed)
    backbone = randomize_variables({c: variables[c]['backbone']
                                    for c in ('params', 'batch_stats')}, rs)
    for name, block in backbone['params'].items():
        if not name.endswith('deconv') and 'upper_bn2' in block:
            block['upper_bn2']['scale'] = block['upper_bn2']['scale'] * 0.25
    for name in ('conv2_kernel', 'conv2_bias'):
        backbone['params']['layer8'][name] *= pf_scale
    return {c: {'backbone': backbone[c]} for c in ('params', 'batch_stats')}


def _both(path, seed, spec='pair_spec', keys=(41, 42), pf_scale=PF_SCALE):
    """The JAX and port models with the same weights, and the same pairs
    (the test spec's or the train spec's) on both sides."""
    built = jconfig.build_model(_small_config(jconfig, path))
    jspec = getattr(built, spec)
    images, corners, delta = _injected(seed=seed, batch=BATCH)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    k1, k2 = (jax.random.split(jax.random.PRNGKey(k), BATCH) for k in keys)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), k1, k2, jspec)
    variables = _variables(built, jbatch, seed + 100, pf_scale)
    tbuilt = tconfig.build_model(_small_config(tconfig, path))
    weights.load_state_dict(tbuilt.model,
                            weights.state_dict_from_jax(variables))
    tspec = getattr(tbuilt, spec)
    pds = (jax_photometric_params(k1), jax_photometric_params(k2))
    tbatch = tpipe._assemble_pairs(
        torch.from_numpy(images), torch.from_numpy(corners).long(),
        torch.from_numpy(delta).long(), tspec,
        *(p if on else None for p, on in zip(
            pds, tpipe._photometric_copies(tspec))))
    return (built, variables, jbatch, images, corners, delta, (k1, k2),
            tbuilt, tbatch)


@pytest.fixture(scope='module')
def eval_outputs():
    """S-COCO zeng-orig on the test spec's pairs, eval mode, the PF head's
    output conv at full scale (a field of a few pixels): both sides'
    training forward, the port's predict and JAX's RANSAC postprocess of
    its own field (``assembled.py:774-776``) on the same draws."""
    built, variables, jbatch, *_, tbuilt, tbatch = _both(
        CONFIGS[0], seed=5, spec='test_pair_spec', pf_scale=1.0)
    out = jax.jit(lambda v, b: built.model.apply(v, b, train=False))(
        variables, jbatch)
    n = 32 * 32
    idx = np.array(jax.random.randint(jax.random.PRNGKey(8),
                                      (BATCH, 4 * transac.NUM_HYPOTHESES),
                                      0, n))
    original = jax.random.randint

    def injected(_key, shape, low, high):
        assert tuple(shape) == idx.shape and (low, high) == (0, n)
        return jnp.asarray(idx, jnp.int32)
    jax.random.randint = injected
    try:
        want_delta, _ = jransac.perspective_field_to_delta(
            out['network_output'], jax.random.PRNGKey(1))
    finally:
        jax.random.randint = original
    model = tbuilt.model.eval()
    return {'built': built, 'jbatch': jbatch, 'out': out, 'tbuilt': tbuilt,
            'tbatch': tbatch, 'got': model(tbatch), 'idx': idx,
            'want_delta': np.asarray(want_delta),
            'predict': model.predict(tbatch, idx=torch.from_numpy(idx))}


def test_noop_all_points_forward_and_smoothl1_match_jax(eval_outputs):
    built, out, tbuilt, got = (eval_outputs[k] for k in
                               ('built', 'out', 'tbuilt', 'got'))
    want_loss = float(jlosses.compute_loss(built.loss_name, out))
    got_loss = float(tlosses.compute_loss(tbuilt.loss_name, got).detach())
    assert tbuilt.loss_name == 'SmoothL1Loss'
    assert got['network_output'].shape == (BATCH, 32, 32, 2)
    assert 0.5 < float(got['network_output'].detach().abs().mean()) < 20.0
    for key in ('ground_truth', 'network_output', 'delta_gt', 'delta_hat'):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(out[key]), rtol=0, atol=1e-4,
                                   err_msg=key)
    pf = got['network_output'].detach()
    np.testing.assert_array_equal(
        got['delta_hat'].detach().numpy(),
        torch.stack([pf[:, 0, 0], pf[:, 0, 31], pf[:, 31, 31], pf[:, 31, 0]],
                    1).numpy())
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def test_predict_ransac_matches_jax_with_injected_draws(eval_outputs):
    got, want = eval_outputs['predict'], eval_outputs['want_delta']
    tbatch, jbatch = eval_outputs['tbatch'], eval_outputs['jbatch']
    assert got.shape == (BATCH, 4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)
    mace_t = float(tgeo.mace(tbatch['delta'], got))
    mace_j = float(jgeo.mace(jbatch['delta'], jnp.asarray(want)))
    assert np.isfinite(mace_t) and abs(mace_t - mace_j) < 1e-2
    # Without injected draws they come from the generator.
    model = eval_outputs['tbuilt'].model
    again = [model.predict(tbatch, generator=torch.Generator().manual_seed(0))
             for _ in range(2)]
    assert torch.equal(again[0], again[1]) and torch.isfinite(again[0]).all()


@pytest.fixture(scope='module')
def step_outputs():
    path = CONFIGS[1]
    (built, variables, batch, images, corners, delta, (k1, k2), tbuilt,
     _) = _both(path, seed=6)

    def loss_fn(params):
        out, mutated = built.model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch, train=True, mutable=['batch_stats'])
        return jlosses.compute_loss(built.loss_name, out), (out, mutated)

    (loss, (out, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    _, schedule = jts.make_optimizer(**jconfig.solver_kwargs(
        _small_config(jconfig, path)))
    jmetrics = {'loss/train': loss, 'g_norm/value': optax.global_norm(grads),
                'lr/value': schedule(0),
                'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat'])}

    model = tbuilt.model
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(tbuilt.config))
    tmetrics = trainer.train_step(
        model, opt, torch.from_numpy(images).to(torch.uint8),
        tbuilt.pair_spec, tbuilt.loss_name,
        corners=torch.from_numpy(corners), delta=torch.from_numpy(delta),
        photometric_params=(jax_photometric_params(k1),
                            jax_photometric_params(k2)))
    to_np = jax.tree_util.tree_map(np.asarray, {
        'grads': grads['backbone'], 'stats': mutated['batch_stats']})
    return {'jax_metrics': {k: float(v) for k, v in jmetrics.items()},
            'port_metrics': {k: float(v) for k, v in tmetrics.items()},
            'jax': to_np, 'model': model}


def test_zeng_orig_step_loss_and_metrics_match_jax(step_outputs):
    want, got = step_outputs['jax_metrics'], step_outputs['port_metrics']
    assert set(got) == set(want)
    assert np.isfinite(got['loss/train'])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-5,
                                   err_msg=key)


def test_zeng_orig_step_gradients_match_jax(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': step_outputs['jax']['grads']})
    params = dict(model.backbone.named_parameters())
    assert set(want) == set(params)
    rel_max = []
    for name, want_g in want.items():
        got = params[name].grad
        if name == 'layer8.0.bias':             # analytically 0
            assert got.abs().max() < 1e-3 and want_g.abs().max() < 1e-3
            continue
        l2 = float((got - want_g).norm() / want_g.norm())
        assert l2 < 3e-2, (name, l2)
        rel_max.append(float((got - want_g).abs().max() / want_g.abs().max()))
    assert np.median(rel_max) < 1e-2, np.median(rel_max)


def test_zeng_orig_step_batch_stats(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': {'backbone': {}},
         'batch_stats': step_outputs['jax']['stats']})
    buffers = dict(model.named_buffers())
    assert len(want) == 2 * 54
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
