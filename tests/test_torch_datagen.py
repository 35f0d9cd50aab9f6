"""Port pair synthesis (bihome_torch.data.pipeline) against the JAX
reference (bihome_tpu.data.pipeline), with injected corners and deltas.

Small size: 64x64 images from the synthetic pool, 32x32 patches, rho 8,
batch 2. Tolerance: 1e-4 absolute on standardized patches (float32, the
same formulas; the warp sums its taps in another order), 1e-5 on
homographies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.data import synthetic as jsyn
from bihome_torch.data import pipeline as tpipe
from bihome_torch.data import synthetic as tsyn

ZENG = ('config/s-coco/zeng-bihome-lr-1e-3.yaml',
        'config/pds-coco/zeng-bihome-lr-1e-3.yaml')
KEYS = ('patch_1', 'patch_2', 'corners', 'delta', 'homography', 'target')


def _transforms(path):
    with open(path) as f:
        return yaml.full_load(f)['DATA']['TRANSFORMS']


def _small_spec(module):
    spec = module.PairSpec.from_transforms(_transforms(ZENG[0]))
    return dataclasses.replace(spec, patch_size=32, rho=8)


def _injected(seed=0, batch=2):
    rs = np.random.RandomState(seed)
    images = tsyn.make_image_pool(batch, 64, 64, seed=seed).astype(np.float32)
    pos = rs.randint(24, 41, (batch, 2))
    corners = np.stack([pos - 16, pos + [16, -16], pos + 16,
                        pos + [-16, 16]], 1).astype(np.float32)
    delta = rs.randint(-8, 8, (batch, 4, 2)).astype(np.float32)
    return images, corners, delta


def _compare(got, want, keys=KEYS):
    for key in keys:
        atol = 1e-5 if key == 'homography' else 1e-4
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=atol, err_msg=key)


@pytest.mark.parametrize('path', ZENG)
def test_pair_spec_from_transforms_matches_jax(path):
    want = dataclasses.asdict(jpipe.PairSpec.from_transforms(_transforms(path)))
    got = dataclasses.asdict(tpipe.PairSpec.from_transforms(_transforms(path)))
    assert got == want


def test_synthetic_pool_matches_jax():
    np.testing.assert_array_equal(tsyn.make_image_pool(2, 24, 32, seed=3),
                                  jsyn.make_image_pool(2, 24, 32, seed=3))


def test_generate_pairs_deterministic_matches_jax():
    images, corners, delta = _injected()
    want = jpipe.generate_pairs_deterministic(
        jnp.asarray(images), jnp.asarray(corners), jnp.asarray(delta),
        _small_spec(jpipe))
    got = tpipe.generate_pairs_deterministic(
        torch.from_numpy(images), torch.from_numpy(corners),
        torch.from_numpy(delta), _small_spec(tpipe))
    _compare(got, want)


def test_window_first_assembly_matches_jax():
    images, corners, delta = _injected(seed=1)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    want = jpipe._assemble_pairs(jnp.asarray(images),
                                 jnp.asarray(corners.astype(np.int32)),
                                 jnp.asarray(delta.astype(np.int32)), keys,
                                 keys, _small_spec(jpipe))
    got = tpipe._assemble_pairs(torch.from_numpy(images),
                                torch.from_numpy(corners).long(),
                                torch.from_numpy(delta).long(),
                                _small_spec(tpipe))
    _compare(got, want)


def test_per_sample_synthesis_is_batch_invariant():
    spec = _small_spec(tpipe)
    images = torch.from_numpy(tsyn.make_image_pool(2, 64, 64, seed=2))
    seeds = [tpipe.sample_seed(42, i) for i in range(2)]
    both = tpipe.generate_pairs_per_sample(images, seeds, spec)
    for i in range(2):
        one = tpipe.generate_pairs_per_sample(images[i:i + 1], seeds[i:i + 1],
                                              spec)
        for key in ('patch_1', 'patch_2', 'corners', 'delta'):
            torch.testing.assert_close(one[key][0], both[key][i], rtol=0,
                                       atol=0)
    delta = both['delta']
    assert torch.all((delta >= -8) & (delta < 8))
    centres = both['corners'][:, 0] + 16
    assert torch.all((centres >= 24) & (centres <= 40))


def test_photometric_config_is_not_ported_yet():
    """HomographyNetPrep's PDS distortion (tests/test_torch_photometric.py)
    and the dict-stage full-SSD ``PhotometricDistort`` transform
    (tests/test_torch_datagen_leftovers.py) are both ported now; an image
    the pipeline cannot emit is still refused."""
    tpipe.check_ported(tpipe.PairSpec.from_transforms(_transforms(ZENG[1])))
    spec = tpipe.PairSpec.from_transforms(
        _transforms(ZENG[1]) + [{'PhotometricDistort': [['patch_1']]}])
    assert spec.photometric_full_keys == ('patch_1',)
    tpipe.check_ported(spec)
    with pytest.raises(ValueError, match='not ported yet: emitting'):
        tpipe.check_ported(dataclasses.replace(spec,
                                               emit_images=('image_3',)))


def test_generate_pairs_injected_equals_assembly_and_draws_in_range():
    spec = _small_spec(tpipe)
    images, corners, delta = _injected(seed=3)
    got = tpipe.generate_pairs(torch.from_numpy(images).to(torch.uint8),
                               spec, corners=torch.from_numpy(corners),
                               delta=torch.from_numpy(delta))
    want = tpipe._assemble_pairs(torch.from_numpy(images),
                                 torch.from_numpy(corners).long(),
                                 torch.from_numpy(delta).long(), spec)
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    gen = torch.Generator().manual_seed(0)
    drawn = tpipe.generate_pairs(torch.from_numpy(images), spec, gen)
    assert drawn['patch_2'].shape == (2, 32, 32, 1)
    corners_d, delta_d = tpipe.draw_corners_delta_batch(
        500, (64, 64), spec, torch.Generator().manual_seed(1))
    centres = corners_d[:, 0] + 16
    assert int(centres.min()) == 24 and int(centres.max()) == 40
    assert int(delta_d.min()) == -8 and int(delta_d.max()) == 7
