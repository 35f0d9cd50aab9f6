"""Port Rethinking backbone (bihome_torch.models) against the JAX reference
(bihome_tpu.models.backbones.RethinkingBackbone), with the JAX weights
carried across by ``weights.state_dict_from_jax``.

Small size: DoubleLine, batch 2, 32x32 patches (the widths are fixed by the
architecture). BN statistics and affines are randomized so eval-mode parity
is a real test. Forward tolerance atol 2e-3, rtol 1e-3, as for the
reference-checkpoint import (tests/test_checkpoint_port.py): float32 on
both sides, the JAX side runs its fused deconv reparameterisation.

Training mode (batch statistics) is held against
``RethinkingBackbone.apply(train=True, mutable=['batch_stats'])``: the
outputs (same tolerance), every parameter gradient (within 1e-4 of its
largest entry) and the updated running statistics (1e-4). The last BN of
each residual branch is scaled by 1/4: undamped, the float32 backward of
a random 50-layer batch-statistics network is ill-conditioned, and the
gradients of JAX and of the port differ by percents for rounding alone.
The PF head's first conv bias has an analytically zero
gradient (the batch mean absorbs it) and is held at the noise floor
instead. The stem's BN bias is pushed negative so
the max-pool sees windows of tied zeros, which the test counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models import backbones as jbb
from bihome_tpu.models import torch_port
from bihome_torch.models import backbones as tbb
from bihome_torch.models import norm, weights

KEYS = ('pf_hat_12', 'pf_hat_21')


def randomize_variables(variables, rs):
    """numpy copy of a flax Rethinking tree with random BN statistics,
    BN affines and conv biases."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, 'items'):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k in ('mean', 'bn_mean'):
                v = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif k in ('var', 'bn_var'):
                v = (rs.rand(*v.shape) * 0.5 + 0.75).astype(np.float32)
            elif k in ('scale', 'bn_scale'):
                v = (1.0 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
            elif 'bias' in k:
                v = (0.1 * rs.randn(*v.shape)).astype(np.float32)
            out[k] = v
        return out
    return walk(variables)


def jax_backbone():
    return jbb.RethinkingBackbone(patch_keys=('patch_1', 'patch_2'),
                                  target_keys=KEYS, variant='doubleline')


def torch_backbone(variables):
    model = tbb.RethinkingBackbone(target_keys=KEYS, variant='doubleline')
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    return model.eval()


@pytest.fixture(scope='module')
def reference():
    rs = np.random.RandomState(0)
    data = {k: rs.randn(2, 32, 32, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = randomize_variables(
        jax_backbone().init(jax.random.PRNGKey(0), jdata), rs)
    out = jax_backbone().apply(variables, jdata, train=False)
    return variables, data, {k: np.asarray(v) for k, v in out.items()}


def test_weight_round_trip_is_exact(reference):
    variables, _, _ = reference
    model = torch_backbone(variables)
    port_keys = {k for k in model.state_dict()
                 if not k.endswith('num_batches_tracked')}
    assert set(weights.state_dict_from_jax(variables)) == port_keys
    back = torch_port.port_rethinking_full(
        {k: v.numpy() for k, v in model.state_dict().items()})

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v
    for coll in ('params', 'batch_stats'):
        want = dict(leaves(variables[coll]))
        got = dict(leaves(back[coll]))
        assert got.keys() == want.keys(), coll
        for path, v in want.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def test_doubleline_eval_forward_matches_jax(reference):
    variables, data, want = reference
    model = torch_backbone(variables)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    for key in KEYS:
        assert got[key].shape == want[key].shape == (2, 32, 32, 2)
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-3,
                                   rtol=1e-3, err_msg=key)


def test_pf_head_refuses_training_mode():
    """Training mode used to be refused; it now normalises with the batch
    statistics (the same output as the unfused head in training mode)."""
    torch.manual_seed(0)
    head = tbb.PFHead(16, 128, 2).train()
    plain = torch.nn.Sequential(torch.nn.Conv2d(16, 128, 1),
                                torch.nn.BatchNorm2d(128), torch.nn.ReLU(),
                                torch.nn.Conv2d(128, 2, 1)).train()
    plain.load_state_dict(head.state_dict())
    x = torch.randn(2, 16, 8, 8)
    got = head(x)
    np.testing.assert_allclose(got.detach().numpy(), plain(x).detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(head[1].running_mean.numpy(),
                               plain[1].running_mean.numpy(), atol=1e-6)


def _ties(x_nchw):
    """Number of 3x3/2 pool windows (padding -inf) whose max is tied."""
    pad = torch.nn.functional.pad(x_nchw, (1, 1, 1, 1), value=-np.inf)
    win = pad.unfold(2, 3, 2).unfold(3, 3, 2).reshape(
        *pad.shape[:2], -1, 9)[:, :, :, :]
    mx = win.max(-1, keepdim=True).values
    return int(((win == mx).sum(-1) > 1).sum())


@pytest.fixture(scope='module')
def train_reference():
    rs = np.random.RandomState(3)
    data = {k: rs.randn(2, 32, 32, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = randomize_variables(
        jax_backbone().init(jax.random.PRNGKey(1), jdata), rs)
    variables['params']['layer1_bn']['bias'] = np.full(64, -0.8, np.float32)
    for name, block in variables['params'].items():
        if not name.endswith('deconv') and 'upper_bn2' in block:
            block['upper_bn2']['scale'] = block['upper_bn2']['scale'] * 0.25
    cot = {k: rs.randn(2, 32, 32, 2).astype(np.float32) for k in KEYS}

    def loss(params):
        out, mutated = jax_backbone().apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jdata, train=True, mutable=['batch_stats'])
        return sum(jnp.sum(out[k] * cot[k]) for k in KEYS), (out, mutated)

    grads, (out, mutated) = jax.jit(jax.grad(loss, has_aux=True))(
        variables['params'])
    to_np = jax.tree_util.tree_map(np.asarray, {
        'grads': grads, 'batch_stats': mutated['batch_stats']})
    return (variables, data, cot, {k: np.asarray(v) for k, v in out.items()},
            to_np)


def test_doubleline_train_step_matches_jax(train_reference):
    variables, data, cot, want, ref = train_reference
    model = torch_backbone(variables).train()
    stem = []
    model.layer1.register_forward_hook(
        lambda m, i, o: stem.append(o.detach()))
    out = model({k: torch.from_numpy(v) for k, v in data.items()})
    assert _ties(stem[0]) > 50, 'the max-pool input should have ties'
    for key in KEYS:
        np.testing.assert_allclose(out[key].detach().numpy(), want[key],
                                   atol=2e-3, rtol=1e-3, err_msg=key)
    sum((out[k] * torch.from_numpy(cot[k])).sum() for k in KEYS).backward()

    want_grads = weights.state_dict_from_jax({'params': ref['grads']})
    params = dict(model.named_parameters())
    assert set(want_grads) == set(params)
    for name, want_g in want_grads.items():
        got = params[name].grad.numpy()
        if name == 'layer8.0.bias':
            assert np.abs(got).max() < 1e-3 and want_g.abs().max() < 1e-3
            continue
        scale = max(1e-6, float(want_g.abs().max()))
        np.testing.assert_allclose(got / scale, want_g.numpy() / scale,
                                   rtol=0, atol=1e-4, err_msg=name)

    want_stats = weights.state_dict_from_jax(
        {'params': {}, 'batch_stats': ref['batch_stats']})
    buffers = dict(model.named_buffers())
    assert len(want_stats) == 2 * 54
    for name, want_s in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_s.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_batchnorm_running_variance_is_biased_like_flax():
    """At M = 8 the unbiased update (plain nn.BatchNorm2d) is 8/7 times the
    flax one in its batch term; the port's BatchNorm2d matches flax."""
    import flax.linen as fnn
    rs = np.random.RandomState(0)
    x = rs.randn(2, 2, 2, 3).astype(np.float32) * 2.0 + 0.5      # NHWC, M=8
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_y, mutated = bn.apply(variables, jnp.asarray(x),
                               mutable=['batch_stats'])
    want_var = np.asarray(mutated['batch_stats']['var'])
    x_t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    ours = norm.BatchNorm2d(3).train()
    got_y = ours(x_t)
    np.testing.assert_allclose(got_y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_var.numpy(), want_var, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        ours.running_mean.numpy(),
        np.asarray(mutated['batch_stats']['mean']), rtol=1e-6, atol=1e-6)
    stock = torch.nn.BatchNorm2d(3).train()
    stock(x_t)
    batch_var = (want_var - 0.9) / 0.1
    np.testing.assert_allclose((stock.running_var.numpy() - 0.9) / 0.1,
                               batch_var * 8 / 7, rtol=1e-4)
    assert np.abs(stock.running_var.numpy() - want_var).max() > 1e-2
