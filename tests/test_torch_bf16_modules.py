"""The port's modules at bfloat16 (MODEL.DTYPE bfloat16) against the JAX
reference's flax modules built with ``dtype=jnp.bfloat16``.

* BatchNorm (``models/norm.py``) against ``nn.BatchNorm(dtype=bf16)``:
  bf16 in, statistics and affine in float32, bf16 out; eval and train
  (output, the running statistics, the gradients of x, scale and bias).
* A ResNet34 block with a strided projection (``models/blocks.py``)
  against ``blocks.ResNet34ConvBlock(dtype=bf16)``, eval and train; the
  same for the ResNet50 flavour's bottleneck with a strided projection
  (``ResNet50ConvBlock``) and its 2x upsampling block
  (``ResNet50DeconvBlock``, the deconv and 3x3 conv fused on both sides).
* Max-pool on bf16 input with real ties (a ReLU output quantized to
  halves): forward exactly, each window's cotangent routed to the same
  element.
* The double-line loss tail on bf16 features and masks, summed in float32
  (``tests/test_fused_loss.py:131``'s setting on the JAX side).
* The ContentAware backbone (FIX_MASK, the zhang-orig configs) at 64x64,
  DoubleLine, batch 2: eval and train forwards.
* Pair synthesis with the train spec's bf16 warp source (``warp_dtype``
  bfloat16) on injected draws.

Tolerances. The two sides round at the same points and sum exact bf16
products in float32 in other orders; an element whose float32 value lands
on the other side of a bf16 rounding boundary then differs by one bf16 ulp
(2**-8 relative), and the next layer carries that on. BN, the loss tail,
pool and the datagen: the float32 tests' tolerances except at such
elements, which are counted (relative L2 1e-3 where the outputs are bf16;
5e-3 for BN's dx in training mode, where flax rounds twice, see there).
The blocks: 1e-2 relative L2 on outputs and gradients (two or three
convolutions and batch normalisations deep; readings 0 in eval mode, at
most 5.5e-3 in training for the ResNet34 block, 5.9e-3 for the ResNet50
ones), which the same block at float32 must miss (it reads up to 5.8e-2
and 4.6e-2; the ResNet50 ones 5.7e-2 to 0.106). ContentAware: the masks exactly, the
features 2e-3 relative L2 (JAX at float32 stands 6.3e-3 to 6.8e-3 from
JAX at bf16), the deltas of the ResNet34 regressor (36 layers at bf16)
2e-2 in eval mode and 5e-2 in training (see there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.models import backbones as jbb
from bihome_tpu.models import blocks as jblocks
from bihome_tpu.ops import color as jcolor
from bihome_tpu.ops import fused_loss as jloss
from bihome_tpu.ops import pool as jpool
from bihome_torch.data import pipeline as tpipe
from bihome_torch.models import backbones as tbb
from bihome_torch.models import blocks as tblocks
from bihome_torch.models import layers, norm, weights
from bihome_torch.ops import color as tcolor
from bihome_torch.ops import fused_loss as tloss
from bihome_torch.ops.pool import max_pool_3x3_s2
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_bf16_head import rel_l2
from tests.test_torch_datagen import ZENG, _injected, _small_spec

BF16 = torch.bfloat16
BLOCK_L2 = 1e-2


def _nchw(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(
        a, np.float32).transpose(0, 3, 1, 2)))
    return t if dtype is None else t.to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batch_norm_bf16_matches_flax(train):
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 6, 5, 8) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.2 * rs.randn(8)).astype(np.float32)
    bias = (0.1 * rs.randn(8)).astype(np.float32)
    mean = (0.1 * rs.randn(8)).astype(np.float32)
    var = (0.75 + 0.5 * rs.rand(8)).astype(np.float32)
    cot = rs.randn(*x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.bfloat16)
    variables = {'params': {'scale': jnp.asarray(scale),
                            'bias': jnp.asarray(bias)},
                 'batch_stats': {'mean': jnp.asarray(mean),
                                 'var': jnp.asarray(var)}}

    def jfn(xj, params):
        y, mut = bn.apply({'params': params,
                           'batch_stats': variables['batch_stats']}, xj,
                          mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mut)

    (gx, gp), (want, mut) = jax.grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x).astype(jnp.bfloat16), variables['params'])
    assert want.dtype == jnp.bfloat16

    layer = norm.BatchNorm2d(8).train(train)
    with torch.no_grad():
        for name, v in (('weight', scale), ('bias', bias),
                        ('running_mean', mean), ('running_var', var)):
            getattr(layer, name).copy_(torch.from_numpy(v))
    xt = _nchw(x, BF16).requires_grad_(True)
    got = layer(xt)
    assert got.dtype == BF16
    (got.float() * _nchw(cot)).sum().backward()
    assert rel_l2(_nhwc(got), np.asarray(want, np.float32)) <= 1e-3
    # In training mode flax's autodiff rounds dx's direct term and its
    # statistics' term to bf16 apart and adds them in bf16 (x reaches the
    # normalisation and the statistics through two casts); torch rounds
    # their float32 sum once. So dx differs there by an ulp at about a
    # third of the elements.
    assert rel_l2(_nhwc(xt.grad), np.asarray(gx, np.float32)) <= (
        5e-3 if train else 1e-3)
    np.testing.assert_allclose(layer.weight.grad.numpy(), gp['scale'],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(layer.bias.grad.numpy(), gp['bias'],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               mut['batch_stats']['mean'], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               mut['batch_stats']['var'], rtol=1e-5,
                               atol=1e-6)


def _block_state(variables, fields=weights._R34):
    """flax block tree (a ResNet34ConvBlock's, or the block of
    ``fields``) -> the port block's state dict."""
    return weights.block_state_dict(variables, fields)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_resnet34_block_bf16_matches_flax(train):
    rs = np.random.RandomState(5)
    x = np.maximum(rs.randn(2, 16, 16, 8), 0).astype(np.float32)
    net = jblocks.ResNet34ConvBlock(features=16, stride=2,
                                    dtype=jnp.bfloat16)
    variables = randomize_variables(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x)), rs)
    cot = rs.randn(2, 8, 8, 16).astype(np.float32)

    def jfn(xj, params):
        y, _ = net.apply({'params': params,
                          'batch_stats': variables['batch_stats']}, xj,
                         train=train, mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (gx, gp), want = jax.grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables['params'])
    assert want.dtype == jnp.bfloat16

    want = {'y': np.asarray(want, np.float32),
            'dx': np.asarray(gx, np.float32)}
    for name, (prefix, kind) in weights._R34.items():
        if kind == 'conv':
            want[prefix] = weights._kernel(np.asarray(gp[name]['kernel']))
    readings = {}
    for dtype in (BF16, torch.float32):
        block = layers.set_compute_dtype(
            tblocks.ResNet34ConvBlock(8, 16, 2), dtype)
        block.load_state_dict(_block_state(variables), strict=False)
        block.train(train)
        xt = _nchw(x).requires_grad_(True)
        got = block(xt)
        assert got.dtype == dtype
        (got.float() * _nchw(cot)).sum().backward()
        grads = dict(block.named_parameters())
        assert all(grads[f'{p}.weight'].grad.dtype == torch.float32
                   for p in want if p not in ('y', 'dx'))
        readings[str(dtype)] = {
            k: rel_l2(_nhwc(got) if k == 'y' else _nhwc(xt.grad) if k == 'dx'
                      else grads[f'{k}.weight'].grad.numpy(), w)
            for k, w in want.items()}
    print(f'block against JAX at bf16, relative L2: {readings}')
    # The port at bf16 within BLOCK_L2 everywhere; the port at float32
    # (the control, no rounding) misses it somewhere.
    assert max(readings[str(BF16)].values()) <= BLOCK_L2
    assert max(readings[str(torch.float32)].values()) > BLOCK_L2


# The ResNet50-flavour Rethinking backbone's blocks: a bottleneck with a
# strided projection and the 2x upsampling block (its deconv and 3x3 conv
# fused into one convolution on both sides).
R50_BLOCKS = {
    'bottleneck': (lambda: jblocks.ResNet50ConvBlock(
        features=32, stride=2, dtype=jnp.bfloat16),
        lambda: tblocks.ResNet50ConvBlock(16, 32, 2), weights._R50,
        (2, 16, 16, 16), (2, 8, 8, 32)),
    'deconv': (lambda: jblocks.ResNet50DeconvBlock(dtype=jnp.bfloat16),
               lambda: tblocks.ResNet50DeconvBlock(16), weights._DECONV50,
               (2, 8, 8, 16), (2, 16, 16, 8))}


@pytest.mark.parametrize('block', sorted(R50_BLOCKS))
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_resnet50_blocks_bf16_match_flax(train, block):
    """As the ResNet34 block's test: outputs and gradients within
    BLOCK_L2 of flax at bf16, which the port's block at float32 misses."""
    jnet, tnet, fields, xshape, yshape = R50_BLOCKS[block]
    rs = np.random.RandomState(6)
    x = np.maximum(rs.randn(*xshape), 0).astype(np.float32)
    net = jnet()
    variables = randomize_variables(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x)), rs)
    cot = rs.randn(*yshape).astype(np.float32)

    def jfn(xj, params):
        y, _ = net.apply({'params': params,
                          'batch_stats': variables['batch_stats']}, xj,
                         train=train, mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (gx, gp), want = jax.grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables['params'])
    assert want.dtype == jnp.bfloat16
    want = {'y': np.asarray(want, np.float32),
            'dx': np.asarray(gx, np.float32)}
    for name, (prefix, kind) in fields.items():
        if kind != 'bn':
            want[prefix] = weights._kernel(np.asarray(gp[name]['kernel']))
    readings = {}
    for dtype in (BF16, torch.float32):
        module = layers.set_compute_dtype(tnet(), dtype)
        module.load_state_dict(_block_state(variables, fields), strict=False)
        module.train(train)
        xt = _nchw(x).requires_grad_(True)
        got = module(xt)
        assert got.dtype == dtype
        (got.float() * _nchw(cot)).sum().backward()
        params = dict(module.named_parameters())
        readings[str(dtype)] = {
            k: rel_l2(_nhwc(got) if k == 'y' else _nhwc(xt.grad) if k == 'dx'
                      else params[f'{k}.weight'].grad.numpy(), w)
            for k, w in want.items()}
    print(f'{block} against JAX at bf16, relative L2: {readings}')
    assert max(readings[str(BF16)].values()) <= BLOCK_L2
    assert max(readings[str(torch.float32)].values()) > BLOCK_L2


def test_max_pool_bf16_ties_route_as_jax():
    rs = np.random.RandomState(7)
    x = np.maximum(np.round(rs.randn(2, 15, 17, 3) * 2) / 2, 0).astype(
        np.float32)
    g = rs.randn(2, 8, 9, 3).astype(np.float32)
    window = ((1, 1), (1, 1))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    want = jpool.max_pool(xj, (3, 3), (2, 2), window)
    want_dx = jax.grad(lambda a: jnp.sum(
        (jpool.max_pool(a, (3, 3), (2, 2), window) * gj)
        .astype(jnp.float32)))(xj)
    xt = _nchw(x, BF16).requires_grad_(True)
    out = max_pool_3x3_s2(xt)
    assert out.dtype == BF16
    (out * _nchw(g, BF16)).float().sum().backward()
    np.testing.assert_array_equal(_nhwc(out), np.asarray(want, np.float32))
    got_dx = _nhwc(xt.grad)
    want_dx = np.asarray(want_dx, np.float32)
    assert (x == 0).mean() > 0.4, 'the input should be mostly tied zeros'
    np.testing.assert_array_equal(got_dx != 0, want_dx != 0)
    # An element that wins several windows sums their bf16 cotangents:
    # one bf16 ulp of the sum apart at most.
    np.testing.assert_allclose(got_dx, want_dx, rtol=2 ** -7, atol=0)


def test_triplet_loss_tail_bf16_sums_in_float32():
    rs = np.random.RandomState(9)
    b, h, w, c = 3, 6, 5, 8
    args = [rs.randn(2 * b, h, w, c), rs.randn(2 * b, h, w, c),
            rs.uniform(0.05, 1.0, (b, h, w)), rs.uniform(0.05, 1.0, (b, h, w))]
    args = [a.astype(np.float32) for a in args]

    def jfn(*a):
        ln1, ln2, metrics = jloss.triplet_double_line(
            *a, 0.02, 'channel-agnostic', True, True)
        return 0.7 * ln1 + 1.3 * ln2, (ln1, ln2, metrics)

    jgrads, (jln1, jln2, jmetrics) = jax.grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in args])
    targs = [torch.from_numpy(a).to(BF16).requires_grad_(True) for a in args]
    ln1, ln2, metrics = tloss.triplet_double_line(
        *targs, 0.02, 'channel-agnostic', True, True)
    assert ln1.dtype == torch.float32
    for got, want in zip((ln1, ln2) + tuple(metrics),
                         (jln1, jln2) + tuple(jmetrics)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-6)
    (0.7 * ln1 + 1.3 * ln2).backward()
    for t, want in zip(targs, jgrads):
        assert t.grad.dtype == BF16
        assert rel_l2(t.grad.float().numpy(),
                      np.asarray(want, np.float32)) <= 1e-3


CA_KEYS = ('delta_hat_12', 'delta_hat_21')


def test_content_aware_bf16_matches_jax():
    rs = np.random.RandomState(4)
    data = {k: rs.randn(2, 64, 64, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    kwargs = dict(target_keys=CA_KEYS, variant='doubleline', fix_mask=True)
    net = jbb.ContentAwareBackbone(**kwargs, dtype=jnp.bfloat16)
    variables = randomize_variables(net.init(jax.random.PRNGKey(0), jdata),
                                    rs)
    for name, block in variables['params']['resnet34'].items():
        if name.startswith('layer'):
            block['bn2']['scale'] = block['bn2']['scale'] * 0.25
    model = tbb.ContentAwareBackbone(**kwargs)
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    layers.set_compute_dtype(model, BF16)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    for train in (False, True):
        want, _ = net.apply(variables, jdata, train=train,
                            mutable=['batch_stats'])
        got = model.train(train)(tdata)
        np.testing.assert_array_equal(got['mask_1'].numpy(),
                                      np.asarray(want['mask_1']))
        errs = {}
        for key in CA_KEYS + ('feature_1', 'feature_2'):
            assert got[key].dtype == BF16, key
            errs[key] = rel_l2(got[key].detach().float(), np.asarray(
                want[key], np.float32))
        print(f'ContentAware train={train}: port bf16 vs JAX bf16 ' + ', '.join(
            f'{k} {v:.2e}' for k, v in errs.items()))
        # The features, three convolutions deep, where JAX at float32
        # stands 6.3e-3 to 6.8e-3 from JAX at bf16.
        assert max(errs['feature_1'], errs['feature_2']) <= 2e-3, errs
        # The deltas, 36 layers deep: one-ulp differences multiply with
        # depth (a 3x3 conv spreads each to 9 x 64 sums), and batch
        # statistics over 16 values per channel (layer4) amplify them in
        # training; JAX at float32 stands 8.1e-3 to 9.4e-3 (eval) and
        # 2.3e-2 to 3.0e-2 (train) from JAX at bf16.
        limit = 5e-2 if train else 2e-2
        assert max(errs[k] for k in CA_KEYS) <= limit, errs


@pytest.mark.parametrize('path', ZENG, ids=['s-coco', 'pds-coco'])
def test_datagen_bf16_warp_source_matches_jax(path):
    """patch_2 within the float32 test's 1e-4 of JAX's, except where the
    float32 gray sources of the two sides round to different bf16 values
    (a gray value within float32 rounding of a bf16 rounding boundary):
    there one bf16 ulp of the gray value (at most 1.0 of 0..255, 1 /
    (255 * 0.129) standardized) per such tap. The other keys as in the
    float32 test. PDS: its distortion's float32 values differ between the
    sides by up to the float32 test's tolerance, so near-boundary values
    are more frequent there."""
    spec_kw = dict(warp_dtype='bfloat16')
    if path == ZENG[0]:
        jspec = dataclasses.replace(_small_spec(jpipe), **spec_kw)
        tspec = dataclasses.replace(_small_spec(tpipe), **spec_kw)
    else:
        from tests.test_torch_photometric import _pds_spec
        jspec = dataclasses.replace(_pds_spec(jpipe, path), **spec_kw)
        tspec = dataclasses.replace(_pds_spec(tpipe, path), **spec_kw)
    images, corners, delta = _injected(seed=12, batch=3)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    k1 = jax.random.split(jax.random.PRNGKey(21), 3)
    k2 = jax.random.split(jax.random.PRNGKey(22), 3)
    want = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                 jnp.asarray(delta), k1, k2, jspec)
    params = ()
    if path == ZENG[1]:
        from tests.test_torch_photometric import jax_photometric_params
        params = (jax_photometric_params(k1), jax_photometric_params(k2))
    got = tpipe._assemble_pairs(torch.from_numpy(images),
                                torch.from_numpy(corners).long(),
                                torch.from_numpy(delta).long(), tspec,
                                *params)
    for key in ('patch_1', 'corners', 'delta', 'homography', 'target'):
        atol = 1e-5 if key == 'homography' else 1e-4
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=atol, err_msg=key)
    assert got['patch_2'].dtype == torch.float32
    diff = np.abs(got['patch_2'].numpy() - np.asarray(want['patch_2']))
    ulp = 1.0 / (255.0 * 0.129)
    off = diff > 1e-4
    if path == ZENG[0]:
        # The gray sources' bf16 flips, warped to where patch_2 reads them.
        gray_j = np.array(jcolor.rgb_to_grayscale(jnp.asarray(images)))
        gray_t = tcolor.rgb_to_grayscale(torch.from_numpy(images))
        flips = (torch.from_numpy(gray_j).to(BF16)
                 != gray_t.to(BF16)).float()
        reads = tpipe._warp_patches(
            flips, got['homography'], got['corners'][:, 0], tspec.patch_size,
            tspec.rho).numpy() > 0
        print(f'{path}: {int(flips.sum())} gray pixels round to other bf16 '
              f'values; {int(off.sum())} of {off.size} patch_2 elements off '
              f'by more than 1e-4 (largest {diff.max():.3e}), all reading '
              f'one: {bool(np.all(reads[off]))}')
        assert np.all(reads[off])
    else:
        print(f'{path}: {int(off.sum())} of {off.size} patch_2 elements off '
              f'by more than 1e-4 (largest {diff.max():.3e})')
    assert diff.max() <= ulp + 1e-4
