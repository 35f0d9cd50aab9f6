"""CLEVR-Change (``config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml``: the
CA-UDHN model trained on (original, changed) render pairs through
ChangeAwarePrep, no synthetic homography) against the JAX package.

* ``SyntheticChangeDataset``: the images of every index bit-identical to
  JAX's; the pair sampler's pairs and the loader's batches and pools
  identical in all three modes ('nsc', 'sc', 'both').
* ``assemble_change_pairs`` (grayscale, standardize) within 1e-6.
* The TripletHead on non-square patches (24x32; CLEVR trains on whole
  320x240 renders), FIX_MASK true and false: loss and metrics rtol 1e-4,
  the gradients with respect to the deltas within 1e-4 of their largest
  entry (tests/test_torch_triplet_head.py's tolerances).
* One whole training step at 48x64, batch 2, on pairs of the synthetic
  stand-in: the tolerances of tests/test_torch_train_zhang.py (loss and
  metrics rtol 1e-3; BN statistics 1e-4; gradients each tensor within
  3e-2 relative L2 and the median of (largest difference / largest
  entry) within 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu.data import clevr_change as jclevr
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import assembled as jassembled
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_tpu.models import backbones as jbb
from bihome_tpu.training import losses as jlosses
from bihome_tpu.training import train_state as jts
from bihome_torch import config as tconfig
from bihome_torch.data import clevr_change as tclevr
from bihome_torch.data import pipeline as tpipe
from bihome_torch.heads import assembled as tassembled
from bihome_torch.heads.config import HeadConfig as THeadConfig
from bihome_torch.models import backbones as tbb
from bihome_torch.models import weights
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_train_zhang import _variables

CONFIG = 'config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml'
MODES = ('nsc', 'sc', 'both')


def _datasets(num_images=4, image_size=(32, 24), seed=3):
    return (jclevr.SyntheticChangeDataset(num_images, image_size, seed),
            tclevr.SyntheticChangeDataset(num_images, image_size, seed))


def test_synthetic_change_dataset_is_bit_identical_to_jax():
    jds, tds = _datasets()
    assert len(tds) == len(jds) == 4
    for idx in range(3 * len(jds)):
        want, got = jds.load_image(idx), tds.load_image(idx)
        assert got.dtype == np.uint8 and got.shape == (24, 32, 3)
        np.testing.assert_array_equal(got, want, err_msg=str(idx))
    # The changed renders differ from their original, a little.
    diff = np.abs(tds.load_image(5).astype(int) - tds.load_image(1))
    assert 0 < diff.max() <= 12


@pytest.mark.parametrize('mode', MODES)
def test_pair_sampler_and_loader_match_jax(mode):
    jds, tds = _datasets()
    jsampler = jclevr.ClevrChangePairSampler(jds, 2, 40, mode, random_seed=7)
    tsampler = tclevr.ClevrChangePairSampler(tds, 2, 40, mode, random_seed=7)
    for _ in range(2):                               # two epochs
        np.testing.assert_array_equal(tsampler.epoch_pairs(),
                                      jsampler.epoch_pairs())
    jloader = jclevr.ClevrPairLoader(jds, 2, 6, mode, random_seed=8)
    tloader = tclevr.ClevrPairLoader(tds, 2, 6, mode, random_seed=8)
    got, want = list(tloader.epoch()), list(jloader.epoch())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 24, 32, 3)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tloader.pool(7), jloader.pool(7))


def test_assemble_change_pairs_matches_jax():
    spec_j = jconfig.build_model(jconfig.load_config(CONFIG)).pair_spec
    spec_t = tconfig.build_model(tconfig.load_config(CONFIG)).pair_spec
    assert spec_t.change_aware_keys == ('patch_1', 'patch_2')
    pairs = np.random.RandomState(0).randint(0, 256, (3, 2, 24, 32, 3),
                                             dtype=np.uint8)
    want = jpipe.generate_pairs(jnp.asarray(pairs), jax.random.PRNGKey(0),
                                spec_j)
    got = tpipe.generate_pairs(torch.from_numpy(pairs), spec_t)
    assert set(got) == set(want) == {'patch_1', 'patch_2'}
    for key in got:
        assert got[key].shape == (3, 24, 32, 1)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


HEAD = {'NAME': 'TripletHead', 'VARIANT': 'DoubleLine', 'PATCH_SIZE': 128,
        'PATCH_KEYS': ['patch_1', 'patch_2'],
        'MASK_KEYS': ['mask_1', 'mask_2'],
        'FEATURE_KEYS': ['feature_1', 'feature_2'],
        'TARGET_KEYS': ['delta_hat_12', 'delta_hat_21'], 'LD': 2,
        'MU': 0.01, 'TRIPLET_MARGIN': 1.0,
        'TRIPLET_AGGREGATION': 'channel-agnostic'}


@pytest.mark.parametrize('fix_mask', (True, False),
                         ids=('fix_mask', 'predicted_masks'))
def test_triplet_head_on_non_square_patches_matches_jax(fix_mask):
    b, h, w = 2, 24, 32
    rs = np.random.RandomState(21)
    data = {'patch_1': rs.randn(b, h, w, 1), 'patch_2': rs.randn(b, h, w, 1),
            'feature_1': np.abs(rs.randn(b, h, w, 1)),
            'feature_2': np.abs(rs.randn(b, h, w, 1)),
            'delta_hat_12': rs.uniform(-4, 4, (b, 4, 2)),
            'delta_hat_21': rs.uniform(-4, 4, (b, 4, 2))}
    for key in ('mask_1', 'mask_2'):
        data[key] = (np.ones((b, h, w, 1)) if fix_mask
                     else rs.uniform(0.05, 1.0, (b, h, w, 1)))
    data = {k: v.astype(np.float32) for k, v in data.items()}
    kwargs = dict(target_keys=tuple(HEAD['TARGET_KEYS']),
                  variant='doubleline', fix_mask=fix_mask)
    jmodel = jassembled.AssembledModel(
        backbone=jbb.ContentAwareBackbone(**kwargs),
        head=JHeadConfig.from_yaml(HEAD))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = randomize_variables(jmodel.init(
        jax.random.PRNGKey(0), {k: jdata[k] for k in ('patch_1', 'patch_2')}),
        rs)
    deltas = ('delta_hat_12', 'delta_hat_21')

    def loss_fn(inputs):
        out, _ = jmodel.apply(
            variables, {**jdata, **inputs}, True,
            method=lambda m, d, t: m._triplet_head_forward(d, t),
            mutable=['batch_stats'])
        return out['loss'], out
    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {k: jdata[k] for k in deltas})

    model = tassembled.AssembledModel(tbb.ContentAwareBackbone(**kwargs),
                                      THeadConfig.from_yaml(HEAD))
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    model.train()
    tdata = {k: torch.from_numpy(v).requires_grad_(k in deltas)
             for k, v in data.items()}
    tout = model.triplet_head(tdata)
    tout['loss'].backward()
    np.testing.assert_allclose(tout['loss'].item(), float(loss), rtol=1e-4)
    assert set(tout['metrics']) == set(out['metrics'])
    for key, want in out['metrics'].items():
        np.testing.assert_allclose(float(tout['metrics'][key]), float(want),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    for key in deltas:
        want = np.asarray(grads[key])
        scale = float(np.abs(want).max())
        assert scale > 0, key
        np.testing.assert_allclose(tdata[key].grad.numpy() / scale,
                                   want / scale, rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.fixture(scope='module')
def step_outputs():
    jconf = jconfig.load_config(CONFIG)
    built = jconfig.build_model(jconf)
    ds = jclevr.SyntheticChangeDataset(num_images=4, image_size=(64, 48),
                                       seed=5)
    (pairs,) = list(jclevr.ClevrPairLoader(ds, 2, 2, 'nsc',
                                           random_seed=1).epoch())
    batch = jpipe.generate_pairs(jnp.asarray(pairs), jax.random.PRNGKey(0),
                                 built.pair_spec)
    variables = _variables(built, batch, seed=13)

    def loss_fn(params):
        out, mutated = built.model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch, train=True, rngs=None, mutable=['batch_stats'])
        return jlosses.compute_loss(built.loss_name, out), (out, mutated)

    (loss, (out, mutated)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    _, schedule = jts.make_optimizer(**jconfig.solver_kwargs(jconf))
    jmetrics = {'loss/train': loss, 'g_norm/value': optax.global_norm(grads),
                'lr/value': schedule(0), **out['metrics']}

    tbuilt = tconfig.build_model(tconfig.load_config(CONFIG))
    model = tbuilt.model
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(tbuilt.config))
    tmetrics = trainer.train_step(model, opt, torch.from_numpy(pairs),
                                  tbuilt.pair_spec, tbuilt.loss_name)
    to_np = jax.tree_util.tree_map(np.asarray, {
        'grads': grads['backbone'], 'stats': mutated['batch_stats']})
    return {'jax_metrics': {k: float(v) for k, v in jmetrics.items()},
            'port_metrics': {k: float(v) for k, v in tmetrics.items()},
            'jax': to_np, 'model': model}


def test_clevr_step_loss_and_metrics_match_jax(step_outputs):
    want, got = step_outputs['jax_metrics'], step_outputs['port_metrics']
    assert set(got) == set(want)
    assert 'mace/train' not in got              # real pairs have no delta
    assert np.isfinite(got['loss/train'])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-5,
                                   err_msg=key)


def test_clevr_step_gradients_and_batch_stats_match_jax(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': {'backbone': step_outputs['jax']['grads']}})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    rel_max = []
    for name, want_g in want.items():
        got = params[name].grad
        l2 = float((got - want_g).norm() / want_g.norm())
        assert l2 < 3e-2, (name, l2)
        rel_max.append(float((got - want_g).abs().max() / want_g.abs().max()))
    assert np.median(rel_max) < 1e-2, np.median(rel_max)
    stats = weights.state_dict_from_jax(
        {'params': {'backbone': {}},
         'batch_stats': step_outputs['jax']['stats']})
    buffers = dict(model.named_buffers())
    assert len(stats) == 2 * (36 + 3)
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
