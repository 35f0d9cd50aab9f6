"""Port TripletHead loss (``AssembledModel.triplet_head``) against the JAX
reference ``AssembledModel._triplet_head_forward``, in training mode, with
injected inputs: the two patches, their masks (ones under FIX_MASK,
random in (0, 1) otherwise), the backbone's features and the predicted
deltas of both directions (non-integer, up to 4 px), at 32x32, batch 3,
with the ContentAware backbone's weights carried across (only its feature
extractor runs here: once on each warped patch).

Cases: DoubleLine (the fused tail, ``fused_loss.triplet_double_line`` with
``second_scale=False, plain_grad=True``) and OneLine (the open-coded
branch), each with FIX_MASK true (the closed-form support mask) and false
(the predicted masks warped like the patches), margin 1.0,
channel-agnostic, MU 0.01 (the shipped zhang configs).

Tolerances: the loss and every metric rtol 1e-4 (float32, sums in another
order); the gradients with respect to the deltas, both feature maps, the
masks (FIX_MASK false) and the feature extractor's parameters each within
1e-4 of its largest entry; the extractor's running statistics after its
updates (one per warped patch) 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.heads import assembled as jassembled
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_tpu.models import backbones as jbb
from bihome_torch.heads import assembled as tassembled
from bihome_torch.heads.config import HeadConfig as THeadConfig
from bihome_torch.models import backbones as tbb
from bihome_torch.models import weights
from tests.test_torch_backbone import randomize_variables

HEAD = {'NAME': 'TripletHead', 'PATCH_SIZE': 32,
        'PATCH_KEYS': ['patch_1', 'patch_2'],
        'MASK_KEYS': ['mask_1', 'mask_2'],
        'FEATURE_KEYS': ['feature_1', 'feature_2'],
        'TARGET_KEYS': ['delta_hat_12', 'delta_hat_21'], 'LD': 2,
        'MU': 0.01, 'TRIPLET_MARGIN': 1.0,
        'TRIPLET_AGGREGATION': 'channel-agnostic'}
B, PS = 3, 32
INPUTS = ('delta_hat_12', 'delta_hat_21', 'feature_1', 'feature_2',
          'mask_1', 'mask_2')


def _backbone_kwargs(fix_mask):
    return dict(target_keys=tuple(HEAD['TARGET_KEYS']), variant='doubleline',
                fix_mask=fix_mask)


@pytest.fixture(scope='module', params=[
    ('doubleline', True), ('doubleline', False), ('oneline', True),
    ('oneline', False)], ids=lambda p: f'{p[0]}-fix_mask_{p[1]}')
def case(request):
    variant, fix_mask = request.param
    head = dict(HEAD, VARIANT=variant)
    rs = np.random.RandomState(17 if fix_mask else 18)
    data = {'patch_1': rs.randn(B, PS, PS, 1), 'patch_2': rs.randn(B, PS, PS, 1),
            'feature_1': np.abs(rs.randn(B, PS, PS, 1)),
            'feature_2': np.abs(rs.randn(B, PS, PS, 1)),
            'delta_hat_12': rs.uniform(-4, 4, (B, 4, 2)),
            'delta_hat_21': rs.uniform(-4, 4, (B, 4, 2))}
    if fix_mask:
        data['mask_1'] = data['mask_2'] = np.ones((B, PS, PS, 1))
    else:
        data['mask_1'] = rs.uniform(0.05, 1.0, (B, PS, PS, 1))
        data['mask_2'] = rs.uniform(0.05, 1.0, (B, PS, PS, 1))
    data = {k: v.astype(np.float32) for k, v in data.items()}

    jmodel = jassembled.AssembledModel(
        backbone=jbb.ContentAwareBackbone(**_backbone_kwargs(fix_mask)),
        head=JHeadConfig.from_yaml(head))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = randomize_variables(jmodel.init(
        jax.random.PRNGKey(0), {k: jdata[k] for k in ('patch_1', 'patch_2')}),
        rs)
    grad_keys = INPUTS if not fix_mask else INPUTS[:4]

    def loss_fn(params, inputs):
        out, mutated = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            {**jdata, **inputs}, True,
            method=lambda m, d, t: m._triplet_head_forward(d, t),
            mutable=['batch_stats'])
        return out['loss'], (out, mutated)

    (loss, (out, mutated)), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(
            variables['params'], {k: jdata[k] for k in grad_keys})
    ref = jax.tree_util.tree_map(np.asarray, {
        'metrics': out['metrics'], 'param_grads': grads[0],
        'input_grads': grads[1], 'stats': mutated['batch_stats']})

    model = tassembled.AssembledModel(
        tbb.ContentAwareBackbone(**_backbone_kwargs(fix_mask)),
        THeadConfig.from_yaml(head))
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    model.train()
    tdata = {k: torch.from_numpy(v).requires_grad_(k in grad_keys)
             for k, v in data.items()}
    tout = model.triplet_head(tdata)
    tout['loss'].backward()
    return {'variant': variant, 'loss': float(loss), 'ref': ref,
            'model': model, 'data': tdata, 'out': tout,
            'grad_keys': grad_keys}


def test_triplet_head_loss_and_terms_match_jax(case):
    out, ref = case['out'], case['ref']
    assert np.isfinite(case['loss'])
    np.testing.assert_allclose(out['loss'].item(), case['loss'], rtol=1e-4)
    assert set(out['metrics']) == set(ref['metrics'])
    for key, want in ref['metrics'].items():
        np.testing.assert_allclose(float(out['metrics'][key]), float(want),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    if case['variant'] == 'doubleline':
        terms = sum(float(out['metrics'][f'loss_comp/ln{i}'])
                    for i in (1, 2, 3))
        np.testing.assert_allclose(out['loss'].item(), terms, rtol=1e-5)
    assert out['delta_hat'] is case['data']['delta_hat_12']


def test_triplet_head_gradients_match_jax(case):
    ref, data = case['ref'], case['data']
    for key in case['grad_keys']:
        want = ref['input_grads'][key]
        got = (np.zeros_like(want) if data[key].grad is None
               else data[key].grad.numpy())
        if case['variant'] == 'oneline' and key == 'delta_hat_21':
            # One-line: the 2->1 delta does not enter the loss.
            assert np.abs(want).max() == 0 and np.abs(got).max() == 0
            continue
        scale = float(np.abs(want).max())
        assert scale > 0, key
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)
    want_p = weights.state_dict_from_jax({'params': ref['param_grads']})
    params = dict(case['model'].named_parameters())
    extractor = [k for k in want_p if k.startswith('backbone.feature_')]
    assert len(extractor) == 9
    for name in extractor:
        want = want_p[name].numpy()
        scale = max(1e-12, float(np.abs(want).max()))
        np.testing.assert_allclose(params[name].grad.numpy() / scale,
                                   want / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_triplet_head_updates_extractor_stats_like_flax(case):
    want = weights.state_dict_from_jax(
        {'params': {'backbone': {'resnet34': {}}},
         'batch_stats': case['ref']['stats']})
    buffers = dict(case['model'].named_buffers())
    updates = 2 if case['variant'] == 'doubleline' else 1
    for name, value in want.items():
        if name.startswith('backbone.feature_extractor'):
            np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            if name.endswith('running_mean'):
                count = name.replace('running_mean', 'num_batches_tracked')
                assert int(buffers[count]) == updates
