"""Batch statistics across ranks: the port's BatchNorm2d and PF head
(plain path) on 2 gloo ranks, each on half of x, against one process on
all of x, and against flax's BatchNorm and JAX's PFHead (its reference
composition on the CPU) on all of x.

JAX's sharded step normalises by the global batch (XLA reduces flax's
batch statistics over the devices); a plain DistributedDataParallel wrap
would normalise each rank by its half. Each rank's output and input
gradient, and the parameter gradients summed over the ranks (the
trainer's reduction of a loss that sums over the batch, here sum(y * g);
a loss that averages divides both sides by R), must equal the
one-process ones in float64 to 1e-10; the running statistics must be the
same on both ranks. Each wrong split of Part A (statistics local,
cotangent or moment sums local for dx, dgamma / dw2 from the summed sums)
is planted in turn and must fail that comparison. Against JAX (float32):
outputs and statistics 1e-4, gradients 5e-4 of each one's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bihome_tpu.models import backbones as jbb
from tests import torch_dist_helpers as h

SEED = 3
TOL = 1e-10


@pytest.fixture(scope='module')
def ranks():
    return h.run_ranks(h.stats_worker, 2, SEED)


@pytest.fixture(scope='module')
def whole():
    bn, head = h.stats_inputs(SEED)
    return {'bn': h.bn_case(**bn), 'head': h.head_case(**head)}


def _joined(ranks, part, fault, key):
    return np.concatenate([r[(part, fault)][key] for r in ranks])


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _param_keys(part):
    return (('dgamma', 'dbeta') if part == 'bn' else
            ('0.weight', '0.bias', '1.weight', '1.bias', '3.weight',
             '3.bias'))


@pytest.mark.parametrize('part', ['bn', 'head'])
def test_outputs_and_input_gradients_equal_one_process(ranks, whole, part):
    for key in ('y', 'dx'):
        assert _max_rel(_joined(ranks, part, None, key),
                        whole[part][key]) < TOL, key


@pytest.mark.parametrize('part', ['bn', 'head'])
def test_summed_parameter_gradients_equal_one_process(ranks, whole, part):
    for r in ranks:
        for key in _param_keys(part):
            if key == '0.bias':     # 0 analytically under batch statistics
                assert np.abs(r[(part, None)][key]).max() < 1e-12
                continue
            assert _max_rel(r[(part, None)][key], whole[part][key]) < TOL, key


@pytest.mark.parametrize('part', ['bn', 'head'])
def test_running_statistics_equal_on_both_ranks(ranks, whole, part):
    for key in ('mean', 'var'):
        np.testing.assert_array_equal(ranks[0][(part, None)][key],
                                      ranks[1][(part, None)][key])
        assert _max_rel(ranks[0][(part, None)][key],
                        whole[part][key]) < TOL, key


@pytest.mark.parametrize('part,fault',
                         [('bn', f) for f in h.BN_FAULTS]
                         + [('head', f) for f in h.HEAD_FAULTS])
def test_each_wrong_split_fails(ranks, whole, part, fault):
    worst = max([_max_rel(_joined(ranks, part, fault, k), whole[part][k])
                 for k in ('y', 'dx')]
                + [_max_rel(r[(part, fault)][k], whole[part][k])
                   for r in ranks for k in _param_keys(part)
                   if k != '0.bias'])
    assert worst > 1e-3, (fault, worst)


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1)).astype(np.float32)


def _close(got, want, name, tol=5e-4):
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=name)


def test_batchnorm_on_two_ranks_matches_flax(ranks):
    import flax.linen as fnn
    bn_in, _ = h.stats_inputs(SEED)
    x, g = _nhwc(bn_in['x']), _nhwc(bn_in['g'])
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
    params = {'scale': jnp.asarray(bn_in['weight'], jnp.float32),
              'bias': jnp.asarray(bn_in['bias'], jnp.float32)}
    stats = module.init(jax.random.PRNGKey(0), jnp.asarray(x))['batch_stats']

    def loss(p, xx):
        y, upd = module.apply({'params': p, 'batch_stats': stats}, xx,
                              mutable=['batch_stats'])
        return jnp.sum(y * g), (y, upd['batch_stats'])
    (gp, gx), (y, new_stats) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    got = ranks[0][('bn', None)]
    np.testing.assert_allclose(_nhwc(_joined(ranks, 'bn', None, 'y')),
                               np.asarray(y), rtol=1e-4, atol=1e-4)
    _close(_nhwc(_joined(ranks, 'bn', None, 'dx')), np.asarray(gx), 'dx')
    _close(got['dgamma'], np.asarray(gp['scale']), 'dgamma')
    _close(got['dbeta'], np.asarray(gp['bias']), 'dbeta')
    for key, name in (('mean', 'mean'), ('var', 'var')):
        np.testing.assert_allclose(got[key], np.asarray(new_stats[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_pf_head_on_two_ranks_matches_jax(ranks):
    _, hd = h.stats_inputs(SEED)
    x, g = _nhwc(hd['x']), _nhwc(hd['g'])
    cmid = hd['w1'].shape[0]
    module = jbb.PFHead(cmid)
    f32 = lambda a: jnp.asarray(a, jnp.float32)    # noqa: E731
    params = {'conv1_kernel': f32(hd['w1'][:, :, 0, 0].T[None, None]),
              'conv1_bias': f32(hd['b1']), 'bn_scale': f32(hd['gamma']),
              'bn_bias': f32(hd['beta']),
              'conv2_kernel': f32(hd['w2'][:, :, 0, 0].T[None, None]),
              'conv2_bias': f32(hd['b2'])}
    stats = {'bn_mean': jnp.zeros(cmid), 'bn_var': jnp.ones(cmid)}

    def loss(p, xx):
        y, upd = module.apply({'params': p, 'batch_stats': stats}, xx,
                              train=True, mutable=['batch_stats'])
        return jnp.sum(y * g), (y, upd['batch_stats'])
    (gp, gx), (y, new_stats) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    got = ranks[1][('head', None)]
    np.testing.assert_allclose(_nhwc(_joined(ranks, 'head', None, 'y')),
                               np.asarray(y), rtol=1e-4, atol=1e-4)
    _close(_nhwc(_joined(ranks, 'head', None, 'dx')), np.asarray(gx), 'dx')
    pairs = (('0.weight', 'conv1_kernel'), ('1.weight', 'bn_scale'),
             ('1.bias', 'bn_bias'), ('3.weight', 'conv2_kernel'),
             ('3.bias', 'conv2_bias'))
    for ours, theirs in pairs:
        want = np.asarray(gp[theirs])
        mine = got[ours]
        if mine.ndim == 4:
            mine = mine[:, :, 0, 0].T[None, None]
        _close(mine, want, ours)
    np.testing.assert_allclose(got['mean'], np.asarray(new_stats['bn_mean']),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got['var'], np.asarray(new_stats['bn_var']),
                               rtol=1e-4, atol=1e-5)
