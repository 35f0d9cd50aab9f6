"""Port ContentAwareBackbone (bihome_torch.models.backbones) against the JAX
reference (bihome_tpu.models.backbones.ContentAwareBackbone), FIX_MASK
true (every shipped zhang config) and false (the mask predictor's five
convs, with and without MASK_NORMALIZATION_STRENGTH), with the JAX weights
carried across by ``weights.state_dict_from_jax``.

Small size: DoubleLine, batch 2, 64x64 patches, full width. BN statistics,
BN affines and the fc bias are randomized so eval-mode parity is a real
test; the ResNet34 regressor's last BN of each block is scaled by 1/4 as
in tests/test_torch_resnet34.py. Tolerances: deltas atol 2e-3, rtol 1e-3
(as for the ResNet34 backbone); masks and features (three or five convs
deep) atol 1e-5, rtol 1e-5; running statistics 1e-4 (1e-5 for the
extractor's); the weight round trip exact.

The three BN updates: in training mode the TripletHead re-runs the
feature extractor on each warped patch (``extract_features``), so one step
moves the extractor's running statistics three times, first on the stacked
patches (the backbone's own pass), then on patch_1', then on patch_2'.
Both sides run that sequence here and are compared after the first update
and after the third, which must differ from the first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models import backbones as jbb
from bihome_tpu.models import torch_port
from bihome_torch.models import backbones as tbb
from bihome_torch.models import weights
from tests.test_torch_backbone import randomize_variables

KEYS = ('delta_hat_12', 'delta_hat_21')
SIZE = 64
# (FIX_MASK, MASK_NORMALIZATION_STRENGTH)
CASES = ((True, -1.0), (False, -1.0), (False, 1.5))


def _kwargs(fix_mask, strength):
    return dict(target_keys=KEYS, variant='doubleline', fix_mask=fix_mask,
                mask_normalization_strength=strength)


def torch_backbone(variables, fix_mask, strength):
    model = tbb.ContentAwareBackbone(**_kwargs(fix_mask, strength))
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    return model


def _nhwc(t):
    return t.detach().numpy()


@pytest.fixture(scope='module', params=CASES,
                ids=['fix_mask', 'mask', 'mask_normalized'])
def reference(request):
    fix_mask, strength = request.param
    rs = np.random.RandomState(4)
    data = {k: rs.randn(2, SIZE, SIZE, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}
    warped = [rs.randn(2, SIZE, SIZE, 1).astype(np.float32)
              for _ in range(2)]
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    net = jbb.ContentAwareBackbone(**_kwargs(fix_mask, strength))
    variables = randomize_variables(net.init(jax.random.PRNGKey(0), jdata),
                                    rs)
    for name, block in variables['params']['resnet34'].items():
        if name.startswith('layer'):
            block['bn2']['scale'] = block['bn2']['scale'] * 0.25
    out_eval = net.apply(variables, jdata, train=False)
    out_train, m1 = net.apply(variables, jdata, train=True,
                              mutable=['batch_stats'])
    stats = [m1['batch_stats']]
    for patch in warped:
        _, mut = net.apply({'params': variables['params'],
                            'batch_stats': stats[-1]}, jnp.asarray(patch),
                           train=True, method=net.extract_features,
                           mutable=['batch_stats'])
        stats.append(mut['batch_stats'])
    to_np = jax.tree_util.tree_map(np.asarray, {
        'eval': out_eval, 'train': out_train, 'stats': stats})
    return fix_mask, strength, variables, data, warped, to_np


def test_content_aware_weight_round_trip_is_exact(reference):
    fix_mask, strength, variables, _, _, _ = reference
    model = torch_backbone(variables, fix_mask, strength)
    port_keys = {k for k in model.state_dict()
                 if not k.endswith('num_batches_tracked')}
    assert set(weights.state_dict_from_jax(variables)) == port_keys
    assert any(k.startswith('mask_predictor.') for k in port_keys) \
        == (not fix_mask)
    back = torch_port.port_content_aware(
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


def _compare(got, want, fix_mask):
    for key in KEYS:
        assert got[key].shape == want[key].shape == (2, 4, 2)
        np.testing.assert_allclose(_nhwc(got[key]), want[key], atol=2e-3,
                                   rtol=1e-3, err_msg=key)
    for key in ('mask_1', 'mask_2', 'feature_1', 'feature_2'):
        assert got[key].shape == want[key].shape == (2, SIZE, SIZE, 1)
        np.testing.assert_allclose(_nhwc(got[key]), want[key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    if fix_mask:
        assert np.all(_nhwc(got['mask_1']) == 1.0)
    else:
        assert 0.0 <= _nhwc(got['mask_1']).min() < _nhwc(
            got['mask_1']).max() <= 1.0


def test_content_aware_eval_forward_matches_jax(reference):
    fix_mask, strength, variables, data, _, ref = reference
    model = torch_backbone(variables, fix_mask, strength).eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    _compare(got, ref['eval'], fix_mask)


def test_content_aware_train_forward_and_three_bn_updates(reference):
    fix_mask, strength, variables, data, warped, ref = reference
    model = torch_backbone(variables, fix_mask, strength).train()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    _compare(got, ref['train'], fix_mask)

    def check(stats):
        want = weights.state_dict_from_jax(
            {'params': {'resnet34': {}}, 'batch_stats': stats})
        buffers = dict(model.named_buffers())
        assert len(want) == 2 * (36 + 3 + (0 if fix_mask else 5))
        for name, value in want.items():
            tol = 1e-5 if name.startswith('feature_extractor') else 1e-4
            np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                       rtol=tol, atol=tol, err_msg=name)
    check(ref['stats'][0])
    first = model.feature_extractor.layer3[1].running_var.clone()
    with torch.no_grad():
        for patch in warped:
            model.extract_features(torch.from_numpy(patch))
    check(ref['stats'][2])
    assert not torch.allclose(first, model.feature_extractor.layer3[1]
                              .running_var, rtol=1e-3, atol=0)
    counts = {int(model.feature_extractor.layer1[1].num_batches_tracked),
              int(model.resnet34.bn1.num_batches_tracked)}
    assert counts == {3, 1}
