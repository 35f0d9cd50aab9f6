"""The variants of the biHomE loss (``_triplet_resnet_loss`` and
``_multihead_loss`` of ``bihome_tpu/heads/assembled.py``) in the port's
PerceptualHead against the JAX package's ``AssembledModel.apply``, and the
pieces they use.

The backbone is a pass-through on both sides: it hands back the corner
deltas of both directions and the two masks injected into the batch (and,
for the 'dual' variants, holds a ContentAware feature extractor with
random BN statistics). Pairs: two smooth 32x32 standardized patches,
batch 2; deltas uniform in +-4 px (never integers); masks uniform in
[0.05, 1]; the frozen extractor from aux_clfbh.npz, cut at layer1; the
projection head and the feature extractor filled at JAX's init scales.
Each variant runs the head in training mode and is held on the loss,
every metric, and the gradients of the deltas and (MASK_KEYS) of the
masks; AUXILIARY_RESNET_BN_TRAIN also on the extractor's running
statistics after its two passes.

Tolerances (float32): loss and metrics rtol 1e-4 (atol 1e-6); each
gradient within 1e-3 of its largest entry; running statistics 1e-5.
The gradients are held looser than tests/test_torch_heads.py's 1e-4: a
delta's gradient sums thousands of point terms that cancel, and one
sample's can be small against the others'. Reading: 'projection-bn-train',
the 2->1 deltas of its second sample, 7.0e-4, where the port's float64
gradient stands within 1.5e-7 of float64 central differences (step 1e-7)
of its own loss and JAX's float32 at 7.0e-4 from them; every other case
within 5e-6.
At bfloat16 (the upsample and masked variants), JAX is compiled with XLA's
excess precision off and the port must stand within half of JAX float32's
distance from JAX bf16, on the loss (relative) and the gradients
(relative L2 over all), the policy of tests/test_torch_bf16_heads.py.

Also: the port's upsample grid is jnp.linspace's bit for bit (torch's own
linspace is not); the upsample against JAX's ``_upsample_align_corners``
(values 1e-6, image gradient 1e-5); ``fused_loss.triplet_double_line``'s
mask cotangents against JAX's ``_bwd`` (1e-6 of the largest entry);
``geometry.warp_image`` / ``warp_perspective`` against JAX (1e-5, away
from integer coordinates); and one whole training step of zhang-biHomE
with learned masks (FIX_MASK false, MASK_KEYS), upsample-patch-2x and
AUXILIARY_RESNET_FREEZE false, at 32x32 patches and batch 2, against
JAX's train step (loss and metrics rtol 1e-3; gradients each tensor
within 3e-2 relative L2, the median of (largest difference / largest
entry) within 1e-2, as tests/test_torch_train_zhang.py), the extractor
bitwise unchanged by the port's optimizer step and without gradient in
JAX's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from bihome_tpu import config as jconfig
from bihome_tpu import geometry as jgeo
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.data import synthetic as jsyn
from bihome_tpu.heads import assembled as jassembled
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_tpu.models import backbones as jbb
from bihome_tpu.ops import fused_loss as jfused
from bihome_tpu.training import losses as jlosses
from bihome_tpu.training import train_state as jts
from bihome_tpu.utils import aux_store as jaux
from bihome_torch import config as tconfig
from bihome_torch import geometry as tgeo
from bihome_torch.heads import assembled as tassembled
from bihome_torch.heads.config import HeadConfig as THeadConfig
from bihome_torch.models import backbones as tbb
from bihome_torch.models import layers, weights
from bihome_torch.ops import fused_loss as tfused
from bihome_torch.training import losses as tlosses
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_bf16_heads import _patches
from tests.test_torch_photometric import jax_photometric_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = 'config/pds-coco/zhang-bihome-lr-1e-2.yaml'
B, PS = 2, 32
MASKS = {'MASK_KEYS': ['mask_1', 'mask_2']}
# name -> (MODEL.HEAD overrides, SOLVER.LOSS, the inputs' seed)
CASES = {
    'upsample-2x': ({'SAMPLING_STRATEGY': 'upsample-patch-2x'}, 'biHomE', 83),
    'upsample-4x': ({'SAMPLING_STRATEGY': 'upsample-patch-4x'}, 'biHomE', 84),
    'masks': (MASKS, 'biHomE', 74),
    'masks-one-line-crd': (dict(MASKS, TRIPLET_LOSS='one-line', MASK_CRD=True,
                                TRIPLET_MARGIN=0.5), 'biHomE', 75),
    'one-line-cosine-projection': ({'TRIPLET_LOSS': 'one-line',
                                    'TRIPLET_DISTANCE': 'cosine',
                                    'WITH_PROJECTION_HEAD': [[64, 32],
                                                             [32, 16]]},
                                   'biHomE', 80),
    'l2-channel-aware': ({'TRIPLET_DISTANCE': 'l2',
                          'TRIPLET_AGGREGATION': 'channel-aware'}, 'biHomE',
                         73),
    'cosine-margin': ({'TRIPLET_DISTANCE': 'cosine', 'TRIPLET_MARGIN': 0.1},
                      'biHomE', 71),
    'projection-bn-train': ({'WITH_PROJECTION_HEAD': [[64, 48]],
                             'AUXILIARY_RESNET_BN_TRAIN': True}, 'biHomE', 82),
    'double-line-dual-masks': (dict(MASKS, TRIPLET_LOSS='double-line-dual'),
                               'biHomE', 72),
    'one-line-dual': ({'TRIPLET_LOSS': 'one-line-dual'}, 'biHomE', 81),
    'multihead-cosine': ({'TRIPLET_LOSS': ''}, 'CosineDistance', 77),
}
BF16_CASES = ('upsample-2x', 'masks')
KEYS = ('delta_hat_12', 'delta_hat_21', 'mask_1', 'mask_2')


class JPass(fnn.Module):
    """JAX backbone that returns the deltas and masks injected into the
    batch; its feature extractor runs only for the 'dual' variants."""
    dtype: object = jnp.float32

    def setup(self):
        self.feature_extractor = jbb.FeatureExtractor(
            dtype=self.dtype, name='feature_extractor')

    def __call__(self, batch, train=False):
        return {k: batch[f'injected/{k}'] for k in KEYS}

    def extract_features(self, x, train=False):
        return self.feature_extractor(x, train=train)


class TPass(torch.nn.Module):
    """The port's counterpart of :class:`JPass`."""

    def __init__(self, dual):
        super().__init__()
        if dual:
            self.feature_extractor = tbb.FeatureExtractor()

    def forward(self, batch):
        return {k: batch[f'injected/{k}'] for k in KEYS}

    def extract_features(self, x):
        nchw = x.permute(0, 3, 1, 2).contiguous()
        return self.feature_extractor(nchw).permute(0, 2, 3, 1)


def _head(module, name):
    config = module.load_config(os.path.join(REPO, CONFIG))
    head = dict(config['MODEL']['HEAD'], PATCH_SIZE=PS, **CASES[name][0])
    return head, config['MODEL']['BACKBONE']


def _inputs(name):
    """(pair data, injected deltas and masks), numpy float32."""
    rs = np.random.RandomState(CASES[name][2])
    data = _patches(rs, PS, PS)
    inj = {k: rs.uniform(-4, 4, (B, 4, 2)) for k in KEYS[:2]}
    inj.update({k: rs.uniform(0.05, 1.0, (B, PS, PS, 1)) for k in KEYS[2:]})
    return ({k: np.asarray(v, np.float32) for k, v in data.items()},
            {k: np.asarray(v, np.float32) for k, v in inj.items()})


def _filled(shapes, rs):
    """numpy variables for the flax tree ``shapes`` (``jax.eval_shape`` of
    an init, which runs no forward): conv kernels normal at He's fan-out
    scale and Dense kernels at LeCun's (the JAX inits' scales), BN the
    identity, biases zero."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, 'items'):
                out[k] = walk(v)
                continue
            shape = v.shape
            if k == 'kernel' and len(shape) == 4:
                val = rs.randn(*shape) * np.sqrt(
                    2.0 / (shape[0] * shape[1] * shape[3]))
            elif k == 'kernel':
                val = rs.randn(*shape) / np.sqrt(shape[0])
            elif k in ('scale', 'var'):
                val = np.ones(shape)
            else:
                val = np.zeros(shape)
            out[k] = val.astype(np.float32)
        return out
    return walk(shapes)


def _variables(model, feed):
    """Weights for JAX's head: the extractor from aux_clfbh.npz, the
    projection head and the backbone's feature extractor (dual) filled
    at the init's scales, the latter with random BN statistics and
    affines."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(3), feed,
                                               train=False))
    variables = _filled(shapes, np.random.RandomState(3))
    variables = {c: dict(variables.get(c, {}))
                 for c in ('params', 'batch_stats')}
    aux = jaux.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz'))
    for c in variables:
        variables[c]['auxiliary_resnet'] = aux[c]
        if 'backbone' in variables[c]:
            variables[c]['backbone'] = randomize_variables(
                variables[c]['backbone'], np.random.RandomState(5))
    return variables


@functools.lru_cache(maxsize=None)
def _jax_side(name, dtype='float32'):
    """(loss, metrics, gradients of the injected inputs, new extractor
    statistics, the weights) of JAX's head; each case computed once (the
    bf16 tests read the float32 ones too)."""
    head, backbone = _head(jconfig, name)
    hcfg = JHeadConfig.from_yaml(head, backbone)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    model = jassembled.AssembledModel(backbone=JPass(dtype=jdt), head=hcfg,
                                      dtype=jdt)
    data, inj = _inputs(name)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    feed = {**jdata, **{f'injected/{k}': jnp.asarray(v)
                        for k, v in inj.items()}}
    variables = _variables(model, feed)
    loss_name = CASES[name][1]

    def loss_fn(d):
        out, mutated = model.apply(
            variables, {**jdata, **{f'injected/{k}': v for k, v in d.items()}},
            train=True, mutable=['batch_stats'])
        return jlosses.compute_loss(loss_name, out), (out['metrics'],
                                                      mutated)

    jinj = {k: jnp.asarray(v).astype(jdt) for k, v in inj.items()}
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    if dtype == 'bfloat16':
        step = step.lower(jinj).compile({'xla_allow_excess_precision': False})
    (loss, (metrics, mutated)), grads = step(jinj)
    stats = mutated['batch_stats'].get('auxiliary_resnet')
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(g, np.float64) for k, g in grads.items()},
            stats, variables)


def _port_side(name, variables, dtype='float32'):
    """The same on the port's head, with JAX's weights."""
    head, backbone = _head(tconfig, name)
    cfg = THeadConfig.from_yaml(head, backbone)
    model = tassembled.AssembledModel(TPass('dual' in cfg.triplet_loss), cfg)
    if dtype == 'bfloat16':
        layers.set_compute_dtype(model, torch.bfloat16)
    state = weights.state_dict_from_jax({
        c: {k: v for k, v in variables[c].items() if k != 'backbone'}
        | {'backbone': {}} for c in variables})
    if 'backbone' in variables['params']:
        state.update({f'backbone.{k}': torch.from_numpy(np.array(v))
                      for k, v in weights._conv_bn_layers(
                          'feature_extractor',
                          {c: variables[c]['backbone']
                           for c in variables}).items()})
    weights.load_state_dict(model, state)
    model.train()
    data, inj = _inputs(name)
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    leaves = {k: torch.from_numpy(v).to(tdt).requires_grad_(True)
              for k, v in inj.items()}
    out = model({**{k: torch.from_numpy(v) for k, v in data.items()},
                 **{f'injected/{k}': v for k, v in leaves.items()}})
    loss = tlosses.compute_loss(CASES[name][1], out)
    loss.backward()
    grads = {k: (v.grad.double().numpy() if v.grad is not None
                 else np.zeros(v.shape)) for k, v in leaves.items()}
    return (float(loss.detach()),
            {k: float(v) for k, v in out['metrics'].items()}, grads, model)


def _rel(got, want, tol, name):
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=name)


@pytest.mark.parametrize('name', sorted(CASES))
def test_variant_matches_jax(name):
    jloss, jmetrics, jgrads, jstats, variables = _jax_side(name)
    tloss, tmetrics, tgrads, model = _port_side(name, variables)
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-6)
    assert set(tmetrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(tmetrics[key], value, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    # Each input the variant reads has a gradient on both sides; the
    # others (the 2->1 deltas of a one-line loss, the masks without
    # MASK_KEYS, mask_2 under MASK_CRD) none.
    for key in KEYS:
        if not np.abs(jgrads[key]).max() > 0:
            assert not np.abs(tgrads[key]).max() > 0, key
            continue
        _rel(tgrads[key], jgrads[key], 1e-3, key)
    assert np.abs(jgrads['delta_hat_12']).max() > 0
    if 'masks' in name:
        assert np.abs(jgrads['mask_1']).max() > 0
    if name == 'projection-bn-train':
        def stats(tree):
            return weights.state_dict_from_jax({
                'params': {'backbone': {}, 'auxiliary_resnet': {}},
                'batch_stats': {'backbone': {}, 'auxiliary_resnet': tree}})
        got, init = stats(jstats), stats(
            variables['batch_stats']['auxiliary_resnet'])
        buffers = dict(model.named_buffers())
        for key, want in got.items():
            np.testing.assert_allclose(buffers[key].numpy(), want.numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)
            assert not torch.equal(want, init[key]), key


@pytest.mark.parametrize('name', BF16_CASES)
def test_variant_bf16_sits_with_jax_bf16(name):
    jloss16, _, jgrads16, _, variables = _jax_side(name, 'bfloat16')
    jloss32, _, jgrads32, _, _ = _jax_side(name, 'float32')
    tloss, _, tgrads, _ = _port_side(name, variables, 'bfloat16')
    keys = sorted(jgrads16)

    def errors(loss, grads):
        flat = np.concatenate([grads[k].ravel() for k in keys])
        ref = np.concatenate([jgrads16[k].ravel() for k in keys])
        return (abs(loss - jloss16) / abs(jloss16),
                float(np.linalg.norm(flat - ref) / np.linalg.norm(ref)))
    (loss_err, l2), (loss_err32, l2_32) = (errors(tloss, tgrads),
                                           errors(jloss32, jgrads32))
    print(f'{name} at bf16 against JAX bf16: port loss {loss_err:.2e}, '
          f'gradients {l2:.2e}; JAX f32 {loss_err32:.2e}, {l2_32:.2e}')
    assert np.isfinite(tloss)
    assert loss_err <= 0.5 * loss_err32 and l2 <= 0.5 * l2_32


@pytest.mark.parametrize('h,w,scale', [(32, 32, 2), (32, 32, 4),
                                       (128, 128, 2), (128, 128, 4),
                                       (24, 40, 2)])
def test_upsample_grid_is_jax_linspace_bit_for_bit(h, w, scale):
    for n, num in ((h, h * scale), (w, w * scale)):
        want = np.asarray(jnp.linspace(0.0, n - 1.0, num))
        got = tassembled._linspace(n - 1.0, num, 'cpu').numpy()
        np.testing.assert_array_equal(got, want)
    # torch's own linspace rounds otherwise (the reason for _linspace).
    want = np.asarray(jnp.linspace(0.0, h - 1.0, h * scale))
    assert (torch.linspace(0.0, h - 1.0, h * scale).numpy() != want).any()


@pytest.mark.parametrize('scale', [2, 4])
def test_upsample_matches_jax_values_and_image_gradient(scale):
    rs = np.random.RandomState(scale)
    x = rs.randn(2, 12, 20, 2).astype(np.float32)
    g = rs.randn(2, 12 * scale, 20 * scale, 2).astype(np.float32)

    def jfn(a):
        return jnp.sum(jassembled._upsample_align_corners(a, scale) * g)
    want = np.asarray(jassembled._upsample_align_corners(jnp.asarray(x),
                                                         scale))
    want_g = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tassembled.upsample_align_corners(xt, scale)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0, atol=1e-5)
    # align_corners: the corners are the input's corners.
    np.testing.assert_array_equal(got.detach().numpy()[:, [0, -1]][:, :,
                                                                  [0, -1]],
                                  x[:, [0, -1]][:, :, [0, -1]])


@pytest.mark.parametrize('margin,aggregation', [('inf', 'channel-agnostic'),
                                                (0.3, 'channel-agnostic'),
                                                (0.3, 'channel-aware')])
def test_triplet_double_line_mask_cotangents_match_jax(margin, aggregation):
    rs = np.random.RandomState(17)
    fp = rs.randn(2 * B, 6, 6, 5).astype(np.float32)
    fplain = rs.randn(2 * B, 6, 6, 5).astype(np.float32)
    w1 = rs.uniform(0.0, 1.0, (B, 6, 6)).astype(np.float32)
    w2 = rs.uniform(0.0, 1.0, (B, 6, 6)).astype(np.float32)
    w2[1] *= 0.01                  # a sample whose denominator clamps at 1

    def jfn(a, c, d):
        ln1, ln2, _ = jfused.triplet_double_line(a, jnp.asarray(fplain), c,
                                                 d, margin, aggregation,
                                                 True, False)
        return 0.7 * ln1 + 1.3 * ln2
    want = jax.grad(jfn, argnums=(0, 1, 2))(*(jnp.asarray(v)
                                              for v in (fp, w1, w2)))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (fp, w1, w2)]
    ln1, ln2, _ = tfused.triplet_double_line(
        leaves[0], torch.from_numpy(fplain), leaves[1], leaves[2], margin,
        aggregation, True, False)
    (0.7 * ln1 + 1.3 * ln2).backward()
    for leaf, ref, name in zip(leaves, want, ('fp', 'w1', 'w2')):
        assert float(np.abs(ref).max()) > 0, name
        _rel(leaf.grad.numpy(), np.asarray(ref), 1e-6, name)


@pytest.mark.parametrize('fn', ['warp_image', 'warp_perspective'])
def test_warp_image_and_perspective_match_jax(fn):
    rs = np.random.RandomState(23)
    image = rs.randn(2, 20, 24, 2).astype(np.float32)
    corners = np.broadcast_to(np.float32([[0, 0], [24, 0], [24, 20],
                                          [0, 20]]), (2, 4, 2))
    delta = rs.uniform(-3, 3, (2, 4, 2)).astype(np.float32)
    hom_j = jgeo.four_point_to_homography(jnp.asarray(corners),
                                          jnp.asarray(delta))
    want = np.asarray(getattr(jgeo, fn)(jnp.asarray(image), hom_j,
                                        (18, 22)))
    got = getattr(tgeo, fn)(torch.from_numpy(image),
                            torch.from_numpy(np.array(hom_j)), (18, 22))
    assert got.shape == (2, 18, 22, 2)
    assert float(np.abs(want).max()) > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---- One whole training step against JAX's ---------------------------- #

STEP_SETS = {'BACKBONE': {'FIX_MASK': False},
             'HEAD': {'MASK_KEYS': ['mask_1', 'mask_2'],
                      'SAMPLING_STRATEGY': 'upsample-patch-2x',
                      'AUXILIARY_RESNET_FREEZE': False}}
RHO, IMG = 8, 64


def _step_config(module):
    config = module.load_config(os.path.join(REPO, CONFIG))
    for key in ('TRANSFORMS', 'TEST_TRANSFORM'):
        config['DATA'][key][0]['HomographyNetPrep'][:2] = [RHO, PS]
    for part, sets in STEP_SETS.items():
        config['MODEL'][part].update(sets)
    config['MODEL']['HEAD']['PATCH_SIZE'] = PS
    return config


def _step_pairs():
    rs = np.random.RandomState(31)
    images = jsyn.make_image_pool(B, IMG, IMG, seed=31).astype(np.float32)
    half = PS // 2
    pos = rs.randint(RHO + half, IMG - RHO - half + 1, (B, 2))
    corners = np.stack([pos - half, pos + [half, -half], pos + half,
                        pos + [-half, half]], 1).astype(np.int32)
    delta = rs.randint(-RHO, RHO, (B, 4, 2)).astype(np.int32)
    return images, corners, delta


@pytest.fixture(scope='module')
def step_outputs():
    jconf = _step_config(jconfig)
    built = jconfig.build_model(jconf)
    assert built.head_cfg.sampling_strategy == 'upsample-patch-2x'
    images, corners, delta = _step_pairs()
    k1 = jax.random.split(jax.random.PRNGKey(61), B)
    k2 = jax.random.split(jax.random.PRNGKey(62), B)
    batch = jax.jit(jpipe._assemble_pairs, static_argnums=5)(
        jnp.asarray(images), jnp.asarray(corners), jnp.asarray(delta), k1,
        k2, built.pair_spec)
    variables = _filled(jax.eval_shape(
        built.model.init, {'params': jax.random.PRNGKey(0)}, batch),
        np.random.RandomState(0))
    backbone = randomize_variables({c: variables[c]['backbone']
                                    for c in ('params', 'batch_stats')},
                                   np.random.RandomState(9))
    for name, block in backbone['params']['resnet34'].items():
        if name.startswith('layer'):
            block['bn2']['scale'] = block['bn2']['scale'] * 0.25
    aux = jaux.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz'))
    variables = {c: {'backbone': backbone[c], 'auxiliary_resnet': aux[c]}
                 for c in ('params', 'batch_stats')}

    def loss_fn(params):
        # The train step's cut of the extractor (trainer.py:62-73).
        params = {k: (jax.lax.stop_gradient(v)
                      if k.startswith('auxiliary_resnet') else v)
                  for k, v in params.items()}
        out, mutated = built.model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch, train=True, mutable=['batch_stats'])
        return jlosses.compute_loss(built.loss_name, out), (out, mutated)

    (loss, (out, _)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    tx, schedule = jts.make_optimizer(
        frozen_prefixes=(), **jconfig.solver_kwargs(jconf))
    jmetrics = {'loss/train': loss, 'g_norm/value': optax.global_norm(grads),
                'lr/value': schedule(0),
                'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat']),
                **out['metrics']}

    tbuilt = tconfig.build_model(_step_config(tconfig))
    model = tbuilt.model
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    aux_before = {k: v.clone()
                  for k, v in model.auxiliary_resnet.state_dict().items()}
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(tbuilt.config))
    pds = (jax_photometric_params(k1), jax_photometric_params(k2))
    tmetrics = trainer.train_step(
        model, opt, torch.from_numpy(images).to(torch.uint8),
        tbuilt.pair_spec, tbuilt.loss_name,
        corners=torch.from_numpy(corners), delta=torch.from_numpy(delta),
        photometric_params=pds)
    return {'jax_metrics': {k: float(v) for k, v in jmetrics.items()},
            'port_metrics': {k: float(v) for k, v in tmetrics.items()},
            'grads': jax.tree_util.tree_map(np.asarray, grads),
            'model': model, 'aux_before': aux_before}


def test_masked_upsample_step_matches_jax(step_outputs):
    want, got = step_outputs['jax_metrics'], step_outputs['port_metrics']
    assert set(got) == set(want)
    assert np.isfinite(got['loss/train'])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-5,
                                   err_msg=key)
    # The optimizer step ran on the gradients read below: the port's
    # parameters were updated in place after backward, so compare the
    # gradients it kept.
    model = step_outputs['model']
    jgrads = step_outputs['grads']
    assert not any(np.abs(g).max() > 0 for g in jax.tree_util.tree_leaves(
        jgrads['auxiliary_resnet']))
    want_g = weights.state_dict_from_jax({'params': {'backbone':
                                                     jgrads['backbone']}})
    params = dict(model.named_parameters())
    assert any(k.startswith('backbone.mask_predictor') for k in want_g)
    rel_max = []
    for name, ref in want_g.items():
        g = params[name].grad
        l2 = float((g - ref).norm() / ref.norm())
        assert l2 < 3e-2, (name, l2)
        rel_max.append(float((g - ref).abs().max() / ref.abs().max()))
    assert np.median(rel_max) < 1e-2, np.median(rel_max)


def test_extractor_does_not_move_with_freeze_false(step_outputs):
    model = step_outputs['model']
    assert not model.head.auxiliary_resnet_freeze
    assert not any(p.requires_grad
                   for p in model.auxiliary_resnet.parameters())
    for key, value in model.auxiliary_resnet.state_dict().items():
        assert torch.equal(value, step_outputs['aux_before'][key]), key
