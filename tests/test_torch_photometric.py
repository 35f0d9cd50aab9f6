"""The port's PDS photometric distortion (bihome_torch.ops.color,
bihome_torch.data.photometric) and PDS pair synthesis
(bihome_torch.data.pipeline) against the JAX package.

The random draws are injected: jax.random and torch generators differ, so
the JAX draws are derived from the JAX keys in the JAX split layout of
``bihome_tpu/data/photometric.py:52-94`` (:func:`jax_photometric_params`)
and fed to the port's apply step.

Tolerances: HSV ops 1e-4 relative (1e-4 absolute near 0); the distortion
1e-3 absolute on the 0..255 scale; PDS pair synthesis, both branches, 1e-4
absolute on standardized patches and images (the same formulas in float32;
the warp sums its taps in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.data import photometric as jphoto
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.ops import color as jcolor
from bihome_torch.data import photometric as tphoto
from bihome_torch.data import pipeline as tpipe
from bihome_torch.ops import color as tcolor
from tests.test_torch_datagen import ZENG, _compare, _injected, _transforms

NGUYEN = ('config/s-coco/nguyen-orig-lr-5e-3.yaml',
          'config/pds-coco/nguyen-orig-lr-5e-3.yaml')


@jax.jit
@jax.vmap
def _draws(key):
    """The draws photometric_distort_simple(image, key, 32) makes, in the
    port's column order (tphoto.PARAMS); alphas and hue at max_delta 32."""
    md = 32.0
    lower, upper = 1.0 - md / 32.0 * 0.5, 1.0 + md / 32.0 * 0.5
    keys = jax.random.split(key, 11)
    bern = jax.random.bernoulli
    ln_key1, ln_key2 = jax.random.split(keys[10])
    return jnp.stack([
        bern(keys[0]), jax.random.uniform(keys[1], (), minval=-md, maxval=md),
        bern(keys[2]), bern(keys[3]),
        jax.random.uniform(keys[4], (), minval=lower, maxval=upper),
        bern(keys[5]),
        jax.random.uniform(keys[6], (), minval=lower, maxval=upper),
        bern(keys[7]),
        jax.random.uniform(keys[8], (), minval=-md / 2.0, maxval=md / 2.0),
        bern(keys[9]), bern(ln_key1),
        jax.random.randint(ln_key2, (), 0, 6)]).astype(jnp.float32)


def jax_photometric_params(keys):
    """[B] JAX keys -> [B,12] float32 draws of max_delta 32 as a torch
    tensor (the port's params layout)."""
    return torch.from_numpy(np.array(_draws(keys)))


def _pixels(seed=0, n=4000):
    """RGB pixels [n,3] over -60..320 with the HSV edge cases: r == g ties
    (r, g the max), g == b ties, grey, zero, negative v, and hues just
    below 360 (r the max, b a hair above g)."""
    rs = np.random.RandomState(seed)
    px = rs.uniform(-60, 320, (n, 3)).astype(np.float32)
    k = n // 8
    px[:k, 1] = px[:k, 0]
    px[:k, 2] = px[:k, 0] - rs.uniform(1, 50, k)
    px[k:2 * k, 2] = px[k:2 * k, 1]
    px[2 * k:3 * k] = px[2 * k:3 * k, :1]                        # grey
    px[3 * k:3 * k + 10] = 0.0
    px[3 * k + 10:4 * k] = -np.abs(px[3 * k + 10:4 * k])        # v < 0
    px[4 * k:5 * k, 0] = 250.0
    px[4 * k:5 * k, 1] = 100.0
    px[4 * k:5 * k, 2] = 100.0 + rs.uniform(1e-3, 1e-1, k)      # hue ~360
    return px


def test_rgb_to_hsv_matches_jax():
    px = _pixels()
    want = np.asarray(jcolor.rgb_to_hsv(jnp.asarray(px)))
    got = tcolor.rgb_to_hsv(torch.from_numpy(px)).numpy()
    assert (want[:, 0] > 359.9).sum() > 100, 'hues near 360 expected'
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_hsv_to_rgb_matches_jax():
    hsv = np.asarray(jcolor.rgb_to_hsv(jnp.asarray(_pixels(1))))
    # Sector edges and a hue of exactly 360 (the floor modulo's case).
    edges = np.array([[0.0, 0.5, 100.0], [60.0, 0.3, 200.0],
                      [300.0, 1.0, -20.0], [360.0, 0.7, 150.0],
                      [359.99997, 0.2, 255.0], [180.0, 0.0, 0.0]],
                     np.float32)
    hsv = np.concatenate([hsv, edges]).astype(np.float32)
    want = np.asarray(jcolor.hsv_to_rgb(jnp.asarray(hsv)))
    got = tcolor.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('max_delta', [32.0, 0.0])
def test_photometric_distort_simple_matches_jax(max_delta):
    rs = np.random.RandomState(2)
    images = rs.uniform(0, 255, (24, 6, 7, 3)).astype(np.float32)
    images[:, 0, :, 1] = images[:, 0, :, 0]                       # ties
    keys = jax.random.split(jax.random.PRNGKey(3), 24)
    want = np.asarray(jax.vmap(jphoto.photometric_distort_simple,
                               in_axes=(0, 0, None))(
        jnp.asarray(images), keys, max_delta))
    params = jax_photometric_params(keys) if max_delta > 0 else None
    got = tphoto.apply_photometric(torch.from_numpy(images), params).numpy()
    if max_delta > 0:
        p = params.numpy()
        # Every branch is taken by some sample and skipped by another.
        for col in ('b_coin', 'chain_coin', 's_coin', 'h_coin', 'ln_coin'):
            assert 0 < p[:, tphoto.PARAMS.index(col)].sum() < 24, col
        assert len(set(p[:, -1])) >= 4
        assert np.abs(got - images).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_draw_photometric_params_ranges():
    assert tphoto.draw_photometric_params(8, 0.0) is None
    gen = torch.Generator().manual_seed(0)
    p = tphoto.draw_photometric_params(4000, 32.0, gen)
    assert p.shape == (4000, 12) and p.dtype == torch.float32
    col = {n: p[:, i] for i, n in enumerate(tphoto.PARAMS)}
    for name in ('b_coin', 'chain_coin', 'c1_coin', 's_coin', 'h_coin',
                 'c2_coin', 'ln_coin'):
        assert set(col[name].tolist()) == {0.0, 1.0}
        assert 0.45 < float(col[name].mean()) < 0.55, name
    assert -32 <= col['b_delta'].min() and col['b_delta'].max() < 32
    for name in ('c_alpha', 's_alpha'):
        assert 0.5 <= col[name].min() and col[name].max() < 1.5
    assert -16 <= col['h_delta'].min() and col['h_delta'].max() < 16
    assert set(col['perm'].tolist()) == {0.0, 1.0, 2.0, 3.0, 4.0, 5.0}
    # The channel permutation rows, computed on the device, are the table.
    rows = tphoto._permutation(torch.arange(6.0))
    assert rows.tolist() == [list(r) for r in tphoto._PERMS]


def _pds_spec(module, path, **kw):
    spec = module.PairSpec.from_transforms(_transforms(path), **kw)
    return dataclasses.replace(spec, patch_size=32, rho=8, max_delta=32.0)


@pytest.mark.parametrize('branch', ['window-first', 'full-image'])
def test_pds_pair_synthesis_matches_jax(branch):
    """_assemble_pairs with both copies distorted, against JAX's
    window-first branch (the PDS zeng transforms) and its full-image
    branch (the nguyen transforms, image_1 emitted, grayscaled and
    standardized); the port takes one window-first path for both."""
    images, corners, delta = _injected(seed=5, batch=3)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    k1 = jax.random.split(jax.random.PRNGKey(11), 3)
    k2 = jax.random.split(jax.random.PRNGKey(12), 3)
    if branch == 'window-first':
        path, emit = ZENG[1], ()
    else:
        path, emit = NGUYEN[0], ('image_1',)
    want = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                 jnp.asarray(delta), k1, k2,
                                 _pds_spec(jpipe, path, emit_images=emit))
    got = tpipe._assemble_pairs(torch.from_numpy(images),
                                torch.from_numpy(corners).long(),
                                torch.from_numpy(delta).long(),
                                _pds_spec(tpipe, path, emit_images=emit),
                                jax_photometric_params(k1),
                                jax_photometric_params(k2))
    keys = ('patch_1', 'patch_2', 'corners', 'delta', 'homography', 'target')
    _compare(got, want, keys + (('image_1',) if emit else ()))
    if emit:
        assert got['image_1'].shape == (3, 64, 64, 1)
    plain = tpipe._assemble_pairs(
        torch.from_numpy(images), torch.from_numpy(corners).long(),
        torch.from_numpy(delta).long(),
        dataclasses.replace(_pds_spec(tpipe, path, emit_images=emit),
                            max_delta=0.0))
    assert (got['patch_1'] - plain['patch_1']).abs().max() > 0.05


def test_all_points_target_matches_jax():
    """pds-coco/nguyen-orig's HomographyNetPrep asks for the dense
    'all_points' target (its NoOpHead reads 'delta', not the target)."""
    images, corners, delta = _injected(seed=7, batch=2)
    spec_j = _pds_spec(jpipe, NGUYEN[1])
    spec_t = _pds_spec(tpipe, NGUYEN[1])
    assert spec_t.target_gen == 'all_points'
    k = jax.random.split(jax.random.PRNGKey(0), 2)
    want = jpipe._assemble_pairs(jnp.asarray(images),
                                 jnp.asarray(corners.astype(np.int32)),
                                 jnp.asarray(delta.astype(np.int32)), k, k,
                                 spec_j)
    got = tpipe._assemble_pairs(torch.from_numpy(images),
                                torch.from_numpy(corners).long(),
                                torch.from_numpy(delta).long(), spec_t,
                                jax_photometric_params(k),
                                jax_photometric_params(k))
    assert got['target'].shape == (2, 32, 32, 2)
    _compare(got, want)


def test_pds_draws_per_sample_and_per_batch():
    """Per-sample synthesis stays batch-invariant with the distortion on;
    training synthesis draws the distortion after the corners and deltas,
    so injecting all three equals drawing them from the same generator."""
    spec = _pds_spec(tpipe, ZENG[1])
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (3, 64, 64, 3)).astype(np.uint8))
    seeds = [tpipe.sample_seed(42, i) for i in range(3)]
    both = tpipe.generate_pairs_per_sample(images, seeds, spec)
    for i in range(3):
        one = tpipe.generate_pairs_per_sample(images[i:i + 1],
                                              seeds[i:i + 1], spec)
        torch.testing.assert_close(one['patch_2'][0], both['patch_2'][i],
                                   rtol=0, atol=0)
    drawn = tpipe.generate_pairs(images, spec,
                                 torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    corners, delta = tpipe.draw_corners_delta_batch(3, (64, 64), spec, gen)
    pds = [tphoto.draw_photometric_params(3, 32.0, gen) for _ in range(2)]
    injected = tpipe.generate_pairs(images, spec, corners=corners,
                                    delta=delta, photometric_params=pds)
    for key in ('patch_1', 'patch_2', 'delta'):
        torch.testing.assert_close(drawn[key], injected[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match='needs its draws'):
        tpipe._assemble_pairs(images.float(), corners, delta, spec)
