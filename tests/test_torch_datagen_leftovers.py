"""The datagen and geometry leftovers of the port against the JAX package,
on the CPU, with the draws injected (small sizes: 64x64 images, 32x32
patches, rho 8, batch 3).

* ``photometric_distort_full`` (the dict-stage ``PhotometricDistort``,
  ``bihome_tpu/data/photometric.py:100-145``) on draws read off JAX's
  keys: within 1e-3 on the 0..255 scale, as the PDS distortion.
* The pair with ``PhotometricDistort`` on patch_1, patch_2 and image_2
  and with ``image_2`` emitted (the full frame warped by the pair's
  homography): ``_assemble_pairs`` against JAX's full-image branch,
  patches within 1e-4 (standardized, ``tests/test_torch_datagen.py``'s
  limit), image_2 within 2e-3 on 0..255 (read 1.27e-3: the warp's
  rounding goes through the HSV round trip after it); the draws per key
  as JAX folds them. Training draws: the full chain's after the photometric
  ones, then the blobs', so injecting them equals drawing them.
* The blob occlusion (``bihome_tpu/data/blobs.py``) on JAX's noise and
  shift: the masks equal exactly, patch_2 after the composite within
  1e-6; at porosity 0.3 and blobiness 2 too.
* ``find_homography_dlt(method='eigh')``, unweighted and weighted,
  against JAX's: corner deltas within 1e-3 px (0.5 px noise on 64
  points); on a clean fit it agrees with the Cholesky form within 1e-2
  px (with noise the two estimators part by ~0.07 px).
* ``calc_reprojection_error`` against JAX's, rtol 1e-5.
* ``check_ported`` and the config take PhotometricDistort, image_2 and a
  blob porosity; an unknown emitted image is still refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import geometry as jgeo
from bihome_tpu.data import blobs as jblobs
from bihome_tpu.data import photometric as jphoto
from bihome_tpu.data import pipeline as jpipe
from bihome_torch import geometry as tgeo
from bihome_torch.config import build_model, load_config
from bihome_torch.data import blobs as tblobs
from bihome_torch.data import photometric as tphoto
from bihome_torch.data import pipeline as tpipe
from tests.test_torch_datagen import ZENG, _compare, _injected, _transforms
from tests.test_torch_photometric import jax_photometric_params

FULL_KEYS = ('patch_1', 'patch_2', 'image_2')


@jax.jit
@jax.vmap
def _full_draws(key):
    """The draws photometric_distort_full(image, key) makes, in the port's
    column order (tphoto.PARAMS)."""
    keys = jax.random.split(key, 11)
    bern = jax.random.bernoulli
    ln_key1, ln_key2 = jax.random.split(keys[10])
    return jnp.stack([
        bern(keys[0]), jax.random.uniform(keys[1], (), minval=-32.0,
                                          maxval=32.0),
        bern(keys[2]), bern(keys[3]),
        jax.random.uniform(keys[4], (), minval=0.5, maxval=1.5),
        bern(keys[5]), jax.random.uniform(keys[6], (), minval=0.5,
                                          maxval=1.5),
        bern(keys[7]), jax.random.uniform(keys[8], (), minval=-18.0,
                                          maxval=18.0),
        bern(keys[9]), bern(ln_key1),
        jax.random.randint(ln_key2, (), 0, 6)]).astype(jnp.float32)


def full_params(pdf_keys, n_keys):
    """[K,B,12]: the draws of JAX's per-key fold of ``pdf_keys`` [B]
    (``pipeline.py:309-313``)."""
    return torch.stack([torch.from_numpy(np.array(_full_draws(
        jax.vmap(lambda k, i=i: jax.random.fold_in(k, i))(pdf_keys))))
        for i in range(n_keys)])


def test_photometric_distort_full_matches_jax():
    rs = np.random.RandomState(1)
    images = rs.uniform(0, 255, (24, 6, 7, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 24)
    want = np.asarray(jax.vmap(jphoto.photometric_distort_full)(
        jnp.asarray(images), keys))
    params = torch.from_numpy(np.array(_full_draws(keys)))
    got = tphoto.photometric_distort_full(torch.from_numpy(images), params)
    p = params.numpy()
    for col in ('b_coin', 'chain_coin', 's_coin', 'h_coin', 'ln_coin'):
        assert 0 < p[:, tphoto.PARAMS.index(col)].sum() < 24, col
    assert np.abs(p[:, tphoto.PARAMS.index('h_delta')]).max() > 16
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    drawn = tphoto.draw_photometric_full_params(
        4000, torch.Generator().manual_seed(0))
    col = {n: drawn[:, i] for i, n in enumerate(tphoto.PARAMS)}
    assert -32 <= col['b_delta'].min() and col['b_delta'].max() < 32
    assert 0.5 <= col['s_alpha'].min() and col['s_alpha'].max() < 1.5
    assert -18 <= col['h_delta'].min() and col['h_delta'].max() < 18
    assert col['h_delta'].abs().max() > 17


def _full_spec(module, emit=('image_2',)):
    spec = module.PairSpec.from_transforms(
        _transforms(ZENG[1])[:1] + [{'PhotometricDistort': [list(FULL_KEYS)]}]
        + _transforms(ZENG[1])[1:], emit_images=emit)
    return dataclasses.replace(spec, patch_size=32, rho=8)


def test_pair_with_full_distortion_and_image_2_matches_jax():
    images, corners, delta = _injected(seed=5, batch=3)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    k1 = jax.random.split(jax.random.PRNGKey(11), 3)
    k2 = jax.random.split(jax.random.PRNGKey(12), 3)
    kf = jax.random.split(jax.random.PRNGKey(13), 3)
    spec_j, spec_t = _full_spec(jpipe), _full_spec(tpipe)
    assert spec_t.photometric_full_keys == FULL_KEYS
    tpipe.check_ported(spec_t)
    want = jax.jit(jpipe._assemble_pairs, static_argnums=5)(
        jnp.asarray(images), jnp.asarray(corners), jnp.asarray(delta), k1,
        k2, spec_j, pdf_keys=kf)
    pdf = full_params(kf, len(FULL_KEYS))
    got = tpipe._assemble_pairs(
        torch.from_numpy(images), torch.from_numpy(corners).long(),
        torch.from_numpy(delta).long(), spec_t, jax_photometric_params(k1),
        jax_photometric_params(k2), full_params=pdf)
    _compare(got, want)
    assert got['image_2'].shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got['image_2'].numpy(),
                               np.asarray(want['image_2']), rtol=0,
                               atol=2e-3)
    plain = tpipe._assemble_pairs(
        torch.from_numpy(images), torch.from_numpy(corners).long(),
        torch.from_numpy(delta).long(), spec_t, jax_photometric_params(k1),
        jax_photometric_params(k2))
    for key in FULL_KEYS:
        assert (got[key] - plain[key]).abs().max() > 0.05, key
    # image_2 is the distorted frame warped by the pair's homography.
    frame = tphoto.apply_photometric(torch.from_numpy(images),
                                     jax_photometric_params(k2))
    torch.testing.assert_close(plain['image_2'], tgeo.warp_image(
        frame, plain['homography']), rtol=0, atol=0)


def test_training_draws_full_chain_then_blobs_after_the_pair_draws():
    spec = dataclasses.replace(_full_spec(tpipe, emit=()), blob_porosity=0.5)
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (3, 64, 64, 3)).astype(np.uint8))
    drawn = tpipe.generate_pairs(images, spec,
                                 torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    corners, delta = tpipe.draw_corners_delta_batch(3, (64, 64), spec, gen)
    pds = [tphoto.draw_photometric_params(3, 32.0, gen) for _ in range(2)]
    pdf = tpipe.draw_full_photometric(3, spec, gen)
    assert pdf.shape == (3, 3, 12)
    noise, shift = tblobs.draw_blobs(3, (32, 32), gen)
    assert noise.shape == (3, 32, 32) and 1 <= shift < 3
    injected = tpipe.generate_pairs(images, spec, corners=corners,
                                    delta=delta, photometric_params=pds,
                                    full_params=pdf,
                                    blob_draws=(noise, shift))
    for key in ('patch_1', 'patch_2', 'delta'):
        torch.testing.assert_close(drawn[key], injected[key], rtol=0, atol=0)
    unblobbed = tpipe.generate_pairs(
        images, dataclasses.replace(spec, blob_porosity=0.0),
        corners=corners, delta=delta, photometric_params=pds,
        full_params=pdf)
    torch.testing.assert_close(unblobbed['patch_1'], injected['patch_1'])
    assert (unblobbed['patch_2'] != injected['patch_2']).any()
    # One image: no other sample to take blobs from, as in JAX.
    one = tpipe.generate_pairs(images[:1], spec,
                               torch.Generator().manual_seed(5))
    assert one['patch_2'].shape == (1, 32, 32, 1)


@pytest.mark.parametrize('porosity,blobiness', [(0.5, 1.0), (0.3, 2.0)])
def test_blob_masks_and_composite_match_jax(porosity, blobiness):
    rs = np.random.RandomState(2)
    batch = {'patch_1': jnp.asarray(rs.randn(3, 32, 32, 1), jnp.float32),
             'patch_2': jnp.asarray(rs.randn(3, 32, 32, 1), jnp.float32)}
    key = jax.random.PRNGKey(7)
    want = jblobs.apply_blob_augmentation(batch, key, porosity=porosity,
                                          blobiness=blobiness)
    # The draws apply_blob_augmentation makes from its key (blobs.py:66-70).
    k_shift, k_blobs = jax.random.split(key)
    shift = int(jax.random.randint(k_shift, (), 1, 3))
    keys = jax.random.split(k_blobs, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (32, 32), jnp.float32))
                      for k in keys])
    want_masks = np.stack([np.asarray(jblobs.generate_blobs(
        k, (32, 32), porosity, blobiness)) for k in keys])
    got_masks = tblobs.generate_blobs(torch.from_numpy(noise), porosity,
                                      blobiness)
    assert got_masks.dtype == torch.bool
    np.testing.assert_array_equal(got_masks.numpy(), want_masks)
    assert abs(float(got_masks.float().mean()) - porosity) < 0.01
    got = tblobs.apply_blob_augmentation(
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        torch.from_numpy(noise), shift, porosity, blobiness)
    np.testing.assert_allclose(got['patch_2'].numpy(),
                               np.asarray(want['patch_2']), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got['patch_1'], torch.from_numpy(
        np.array(batch['patch_1'])))


def _fit_points(seed=0, b=3, n=64, noise=0.5):
    rs = np.random.RandomState(seed)
    p1 = rs.uniform(0, 32, (b, n, 2)).astype(np.float32)
    fp = jgeo.image_corners(32, 32, batch_size=b)
    h = jgeo.four_point_to_homography(fp, jnp.asarray(
        rs.uniform(-6, 6, (b, 4, 2)).astype(np.float32)))
    p2 = np.asarray(jgeo.transform_points(h, jnp.asarray(p1)))
    p2 = (p2 + rs.normal(0, noise, p2.shape)).astype(np.float32)
    w = rs.uniform(0.1, 1.0, (b, n)).astype(np.float32)
    return p1, p2, w


def _corner_deltas(h):
    fp = tgeo.image_corners(32, 32, batch_size=h.shape[0], dtype=h.dtype)
    return (tgeo.transform_points(h, fp) - fp).numpy()


@pytest.mark.parametrize('weighted', [False, True])
def test_eigh_dlt_matches_jax(weighted):
    p1, p2, w = _fit_points(seed=3)
    jw = jnp.asarray(w) if weighted else None
    want = jax.jit(lambda a, b, c: jgeo.find_homography_dlt(
        a, b, c, method='eigh'))(jnp.asarray(p1), jnp.asarray(p2), jw)
    tw = torch.from_numpy(w) if weighted else None
    got = tgeo.find_homography_dlt(torch.from_numpy(p1),
                                   torch.from_numpy(p2), tw, method='eigh')
    np.testing.assert_allclose(_corner_deltas(got), _corner_deltas(
        torch.from_numpy(np.array(want))), rtol=0, atol=1e-3)
    # Two estimators (h33 free, or fixed at 1) that agree on a clean fit.
    c1, c2, _ = _fit_points(seed=3, noise=0.0)
    c1, c2 = torch.from_numpy(c1), torch.from_numpy(c2)
    np.testing.assert_allclose(
        _corner_deltas(tgeo.find_homography_dlt(c1, c2, tw, method='eigh')),
        _corner_deltas(tgeo.find_homography_dlt(c1, c2, tw)), rtol=0,
        atol=1e-2)
    with pytest.raises(ValueError):
        tgeo.find_homography_dlt(torch.from_numpy(p1), torch.from_numpy(p2),
                                 method='svd')


def test_calc_reprojection_error_matches_jax():
    p1, p2, _ = _fit_points(seed=4, b=1)
    h = np.asarray(jax.jit(jgeo.find_homography_dlt)(jnp.asarray(p1),
                                                     jnp.asarray(p2)))[0]
    want = float(jgeo.calc_reprojection_error(jnp.asarray(p1[0]),
                                              jnp.asarray(p2[0]),
                                              jnp.asarray(h)))
    got = float(tgeo.calc_reprojection_error(torch.from_numpy(p1[0]),
                                             torch.from_numpy(p2[0]),
                                             torch.from_numpy(h)))
    assert want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_config_takes_the_datagen_leftovers():
    config = load_config(ZENG[1])
    transforms = config['DATA']['TRANSFORMS']
    config['DATA']['TRANSFORMS'] = (transforms[:1] + [
        {'PhotometricDistort': [['patch_1', 'patch_2']]}] + transforms[1:])
    config['DATA']['AUGMENT_BLOB_POROSITY'] = 0.5
    built = build_model(config)
    assert built.pair_spec.photometric_full_keys == ('patch_1', 'patch_2')
    assert built.pair_spec.blob_porosity == 0.5
    tpipe.check_ported(dataclasses.replace(built.test_pair_spec,
                                           emit_images=('image_2',)))
    with pytest.raises(ValueError, match="not ported yet: emitting"):
        tpipe.check_ported(dataclasses.replace(built.test_pair_spec,
                                               emit_images=('image_3',)))
