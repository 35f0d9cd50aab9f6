"""Port Rethinking backbone, ResNet50 flavour (bihome_torch.models), against
the JAX reference (``RethinkingBackbone(resnet_block='ResNet50')``), with
the JAX weights carried across by ``weights.state_dict_from_jax``.

Small size: DoubleLine, batch 2 (4 stacked), 64x64 patches, full width
(bottleneck blocks up to 1024 channels, the PF head Cin 64 / Cmid 512). At
32x32 layer4 would be 2x2; at 64x64 it is 4x4, 64 values per batch
statistic. BN statistics, BN affines and conv biases are randomized so
eval-mode parity is a real test; the last BN of each bottleneck branch
(``upper_bn3``) is scaled by 1/4, as tests/test_torch_backbone.py and
tests/test_torch_resnet34.py damp theirs.

Tolerances. Float32 on both sides (the JAX side runs its fused deconv
reparameterisation): eval outputs atol 2e-3, rtol 1e-3, as for the
ResNet34 flavour; training-mode outputs within 2e-3 + 1e-3 max|out| (the
seeded field is ~70 px; batch statistics over 64 values at layer4 carry
rounding further: 3-4e-3 absolute measured); the updated running
statistics (flax's biased variance) 1e-4; the weight round trip exact.
Gradients are held in float64 on both sides (JAX under ``enable_x64``
with its two-op deconv, ``BIHOME_DECONV_FUSE=off``, since the fused one
is float32-only), each within 1e-5 of its largest entry (1.3e-6 measured;
the PF head's first conv bias, 0 analytically, at the noise floor). In
float32 this damped random 90-layer batch-statistics network is too
ill-conditioned for a gradient test: the two sides' float32 gradients
differ by a median 1.6e-2 of each tensor's largest entry (up to 0.24),
while in float64 they agree to 5e-7 (median): rounding, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models import backbones as jbb
from bihome_tpu.models import torch_port
from bihome_torch.models import backbones as tbb
from bihome_torch.models import blocks, weights
from tests.test_torch_backbone import randomize_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

KEYS = ('pf_hat_12', 'pf_hat_21')
SIZE = 64
# The flavour's parameter count (the ResNet34 flavour has 10,574,178).
R50_PARAMS = 31_169_794


def jax_backbone():
    return jbb.RethinkingBackbone(target_keys=KEYS, variant='doubleline',
                                  resnet_block='ResNet50')


def torch_backbone(variables):
    model = tbb.RethinkingBackbone(target_keys=KEYS, variant='doubleline',
                                   resnet_block='ResNet50')
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    return model


@pytest.fixture(scope='module')
def reference():
    """(variables, data, cotangents, eval outputs, train outputs and new
    batch statistics) of the JAX backbone."""
    rs = np.random.RandomState(5)
    data = {k: rs.randn(2, SIZE, SIZE, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    net = jax_backbone()
    variables = randomize_variables(net.init(jax.random.PRNGKey(2), jdata),
                                    rs)
    for name, block in variables['params'].items():
        if 'upper_bn3' in block:
            block['upper_bn3']['scale'] = block['upper_bn3']['scale'] * 0.25
    out_eval = net.apply(variables, jdata, train=False)
    cot = {k: rs.randn(2, SIZE, SIZE, 2).astype(np.float32) for k in KEYS}

    out_train, mutated = net.apply(variables, jdata, train=True,
                                   mutable=['batch_stats'])
    to_np = jax.tree_util.tree_map(np.asarray, {
        'eval': out_eval, 'train': out_train,
        'batch_stats': mutated['batch_stats']})
    return variables, data, cot, to_np


def test_r50_weight_round_trip_is_exact(reference):
    variables, _, _, _ = reference
    model = torch_backbone(variables)
    port_keys = {k for k in model.state_dict()
                 if not k.endswith('num_batches_tracked')}
    assert set(weights.state_dict_from_jax(variables)) == port_keys
    n_params = sum(p.numel() for p in model.parameters())
    print(f'ResNet50-flavour Rethinking: {n_params:,} parameters')
    assert n_params == R50_PARAMS
    assert tuple(model.layer8[0].weight.shape) == (512, 64, 1, 1)
    back = torch_port.port_rethinking_full(
        {k: v.numpy() for k, v in model.state_dict().items()},
        flavor='ResNet50')

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


def test_r50_eval_forward_matches_jax(reference):
    variables, data, _, ref = reference
    model = torch_backbone(variables).eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    for key in KEYS:
        assert got[key].shape == ref['eval'][key].shape == (2, SIZE, SIZE, 2)
        np.testing.assert_allclose(got[key].numpy(), ref['eval'][key],
                                   atol=2e-3, rtol=1e-3, err_msg=key)


def test_r50_train_forward_and_stats_match_jax(reference):
    variables, data, cot, ref = reference
    model = torch_backbone(variables).train()
    out = model({k: torch.from_numpy(v) for k, v in data.items()})
    for key in KEYS:
        want = ref['train'][key]
        err = np.abs(out[key].detach().numpy() - want).max()
        print(f'train output {key}: max abs error {err:.2e}, '
              f'max |out| {np.abs(want).max():.2f}')
        assert err <= 2e-3 + 1e-3 * np.abs(want).max(), (key, err)
    want_stats = weights.state_dict_from_jax(
        {'params': {}, 'batch_stats': ref['batch_stats']})
    buffers = dict(model.named_buffers())
    assert len(want_stats) == len([k for k in buffers
                                   if k.endswith(('mean', 'var'))])
    for name, want_s in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_s.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_r50_train_gradients_match_jax_in_float64(reference, monkeypatch):
    variables, data, cot, _ = reference
    monkeypatch.setenv('BIHOME_DECONV_FUSE', 'off')
    with jax.enable_x64(True):
        net = jbb.RethinkingBackbone(target_keys=KEYS, variant='doubleline',
                                     resnet_block='ResNet50',
                                     dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64),
                                     variables)
        jdata = {k: jnp.asarray(v, jnp.float64) for k, v in data.items()}

        def loss(params):
            out, _ = net.apply(
                {'params': params, 'batch_stats': v64['batch_stats']},
                jdata, train=True, mutable=['batch_stats'])
            return sum(jnp.sum(out[k] * cot[k].astype(np.float64))
                       for k in KEYS)

        grads = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(v64['params']))
    model = torch_backbone(variables).double().train()
    out = model({k: torch.from_numpy(v).double() for k, v in data.items()})
    sum((out[k] * torch.from_numpy(cot[k]).double()).sum()
        for k in KEYS).backward()
    params = dict(model.named_parameters())
    # The weight map casts to float32: carry each float64 gradient across as
    # a float32 pair, hi + lo (exact to ~1e-14 relative).
    hi = jax.tree_util.tree_map(lambda g: g.astype(np.float32), grads)
    lo = jax.tree_util.tree_map(lambda g, h: (g - h).astype(np.float32),
                                grads, hi)
    want_grads = {
        name: h.double() + lo_t.double() for (name, h), lo_t in zip(
            weights.state_dict_from_jax({'params': hi}).items(),
            weights.state_dict_from_jax({'params': lo}).values())}
    assert set(want_grads) == set(params)
    worst = {}
    for name, want in want_grads.items():
        got = params[name].grad
        if name == 'layer8.0.bias':
            assert got.abs().max() < 1e-3 and want.abs().max() < 1e-3
            continue
        worst[name] = float((got - want).abs().max()
                            / want.abs().max().clamp_min(1e-30))
    name = max(worst, key=worst.get)
    print(f'float64 gradients: worst {name} {worst[name]:.2e}, median '
          f'{np.median(list(worst.values())):.2e} of the largest entry')
    assert worst[name] <= 1e-5, (name, worst[name])


@pytest.mark.parametrize('cin', [1024, 512, 256, 128])
def test_deconv_block_at_r50_widths_matches_jax(cin):
    # The deconv block the ResNet50 flavour runs at 1024, 512, 256 and 128
    # input channels (the ResNet34 one at 256 down to 32), eval and train,
    # against flax at 2 x 4 x 4; tolerance atol 2e-3, rtol 1e-3.
    from bihome_tpu.models import blocks as jblocks

    rs = np.random.RandomState(cin)
    x = rs.randn(2, 4, 4, cin).astype(np.float32)
    net = jblocks.ResNet50DeconvBlock()
    variables = randomize_variables(net.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x)), rs)
    want_eval = net.apply(variables, jnp.asarray(x), train=False)
    want_train, _ = net.apply(variables, jnp.asarray(x), train=True,
                              mutable=['batch_stats'])
    state = weights.state_dict_from_jax(
        {c: {'layer4_deconv': variables[c]} for c in variables})
    block = blocks.ResNet50DeconvBlock(cin)
    weights.load_state_dict(block, {k[len('layer4.6.'):]: v
                                    for k, v in state.items()})
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got_eval = block.eval()(xt)
        got_train = block.train()(xt)
    assert tuple(got_eval.shape) == (2, cin // 2, 8, 8)
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=2e-3, rtol=1e-3)
