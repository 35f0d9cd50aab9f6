"""The flagship's predict extras in the port against the JAX package, on
the CPU: DSAC_PREDICT_REFINE (``dsac.refine_delta_on_pf``, the all-points
IRLS refit) and DSAC_PREDICT_BIDIRECTIONAL (the 2->1 field's fit inverted
through the corner parametrization and averaged with the 1->2 fit).

* ``refine_delta_on_pf`` at iters 1, 2 and 3 on a noisy 32x32 field with
  5% gross outliers (batch 3), from the same 64-point hypothesis: within
  1e-3 px of JAX's (read: at most 5e-5 px; float32 both sides, the refit
  solves 8x8 normal equations over 1,024 weighted points). A bf16 field
  is widened to float32 as JAX widens it: the port's refit of a bf16
  field equals its refit of the field's float32 values, exactly, and
  keeps delta's dtype.
* The head's predict on given fields (a backbone that returns them), at
  REFINE iters 1-3, BIDIRECTIONAL alone and both, JAX's DSAC draws
  injected (one set of uniforms per field, in JAX's order, read off the
  keys JAX's ``sample_point_indices`` gets): within 1e-3 px of JAX's
  ``AssembledModel.predict`` (read: at most 4e-5 px).
* The whole predict at a small width (64x64 images, 32x32 patches, rho 8,
  batch 2, the Rethinking DoubleLine backbone with JAX's weights carried
  across, the PF head scaled so the field is a few pixels) with REFINE at
  iters 2 and BIDIRECTIONAL: within 1e-3 px of JAX's (read: 3e-5 px; the
  backbones agree to ~1e-4 relative, and ``tests/test_torch_predict.py``
  allows 1e-2 px for one 128-point fit without the refit).
* The config refuses neither knob any more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from bihome_tpu import geometry as jgeo
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import assembled as jassembled
from bihome_tpu.heads import dsac as jdsac
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_torch.config import build_model, load_config
from bihome_torch.data import pipeline as tpipe
from bihome_torch.heads import dsac as tdsac
from bihome_torch.heads.assembled import AssembledModel
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models import weights
from bihome_torch.models.backbones import RethinkingBackbone
from tests.test_torch_backbone import KEYS, jax_backbone, randomize_variables
from tests.test_torch_datagen import ZENG, _injected, _small_spec

PF_SCALE = 0.03
# (REFINE, ITERS, BIDIRECTIONAL) of the head cases.
CASES = [(True, 1, False), (True, 2, False), (True, 3, False),
         (False, 1, True), (True, 1, True)]


def _noisy_field(b=3, h=32, w=32, seed=0):
    """A field of a random homography with noise and 5% outliers, and a
    64-point DLT hypothesis of it (as JAX's refine test builds them)."""
    rng = np.random.RandomState(seed)
    delta_gt = jnp.asarray(rng.uniform(-8, 8, (b, 4, 2)).astype(np.float32))
    fp = jnp.broadcast_to(jnp.array([[0, 0], [w, 0], [w, h], [0, h]],
                                    jnp.float32)[None], (b, 4, 2))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing='ij')
    coords = jnp.asarray(np.broadcast_to(
        np.stack([xs.ravel(), ys.ravel()], -1)[None], (b, h * w, 2)).copy())
    mapping = jgeo.transform_points(
        jgeo.four_point_to_homography(fp, delta_gt), coords)
    pf = np.asarray((mapping - coords).reshape(b, h, w, 2))
    pf = (pf + rng.normal(0, 0.5, pf.shape)
          + (rng.rand(b, h, w, 1) < 0.05)
          * rng.uniform(-20, 20, pf.shape)).astype(np.float32)
    idx = rng.choice(h * w, 64, replace=False)
    p1 = coords[:, idx]
    hyp = jgeo.find_homography_dlt(
        p1, p1 + jnp.asarray(pf.reshape(b, -1, 2)[:, idx]))
    delta = np.array(jgeo.transform_points(hyp, fp) - fp)
    return pf, delta


@pytest.mark.parametrize('iters', [1, 2, 3])
def test_refine_delta_on_pf_matches_jax(iters):
    pf, delta = _noisy_field()
    want = np.asarray(jdsac.refine_delta_on_pf(jnp.asarray(pf),
                                               jnp.asarray(delta), 3.0,
                                               iters))
    got = tdsac.refine_delta_on_pf(torch.from_numpy(pf),
                                   torch.from_numpy(delta), 3.0, iters)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 2)
    assert np.abs(want - delta).max() > 0.1, 'the refit should move delta'
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_refine_widens_a_bf16_field_and_keeps_delta_dtype():
    pf, delta = _noisy_field(seed=1)
    pf16 = torch.from_numpy(pf).bfloat16()
    got = tdsac.refine_delta_on_pf(pf16, torch.from_numpy(delta), 3.0, 2)
    want = tdsac.refine_delta_on_pf(pf16.float(), torch.from_numpy(delta),
                                    3.0, 2)
    assert torch.equal(got, want)
    assert tdsac.refine_delta_on_pf(
        pf16, torch.from_numpy(delta).bfloat16(), 3.0).dtype == torch.bfloat16


def _heads(refine, iters, bidirectional):
    """The zeng-biHomE head with the predict knobs, port and JAX."""
    yaml_head = dict(load_config(ZENG[0])['MODEL']['HEAD'])
    yaml_head.update({'DSAC_PREDICT_REFINE': refine,
                      'DSAC_PREDICT_REFINE_ITERS': iters,
                      'DSAC_PREDICT_BIDIRECTIONAL': bidirectional})
    return HeadConfig.from_yaml(yaml_head), JHeadConfig.from_yaml(yaml_head)


def _jax_predict(model, variables, batch, monkeypatch):
    """JAX's predict and the uniforms of its DSAC draws, one [B, P] per
    field in the order it drew them."""
    keys = []
    sample = jdsac.sample_point_indices

    def recording(key, shape, n_points, point_sampling):
        keys.append((key, shape))
        return sample(key, shape, n_points, point_sampling)
    monkeypatch.setattr(jdsac, 'sample_point_indices', recording)
    delta, _ = model.apply(variables, batch, method='predict',
                           rngs={'dsac': jax.random.PRNGKey(3)})
    monkeypatch.setattr(jdsac, 'sample_point_indices', sample)
    uniforms = [torch.from_numpy(np.array(
        jax.random.uniform(key, shape, jnp.float32))) for key, shape in keys]
    return np.asarray(delta), uniforms


class _JaxFields(nn.Module):
    @nn.compact
    def __call__(self, data, train=False):
        return {KEYS[0]: data['pf12'], KEYS[1]: data['pf21']}


class _TorchFields(torch.nn.Module):
    def forward(self, batch):
        return {KEYS[0]: batch['pf12'], KEYS[1]: batch['pf21']}


@pytest.mark.parametrize('refine,iters,bidirectional', CASES)
def test_predict_on_given_fields_matches_jax(refine, iters, bidirectional,
                                             monkeypatch):
    pf12, _ = _noisy_field(b=2, seed=2)
    pf21, _ = _noisy_field(b=2, seed=3)
    head, jhead = _heads(refine, iters, bidirectional)
    jmodel = jassembled.AssembledModel(backbone=_JaxFields(), head=jhead)
    jbatch = {'pf12': jnp.asarray(pf12), 'pf21': jnp.asarray(pf21)}
    want, uniforms = _jax_predict(jmodel, {}, jbatch, monkeypatch)
    assert len(uniforms) == 1 + bidirectional
    model = AssembledModel(_TorchFields(), head).eval()
    got = model.predict({'pf12': torch.from_numpy(pf12),
                         'pf21': torch.from_numpy(pf21)},
                        uniforms=uniforms)
    assert got.shape == (2, 4, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_whole_predict_with_refine_and_bidirectional_matches_jax(
        monkeypatch):
    images, corners, delta = _injected(seed=4)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), keys, keys,
                                   _small_spec(jpipe))
    variables = randomize_variables(
        jax_backbone().init(jax.random.PRNGKey(0), jbatch),
        np.random.RandomState(1))
    for name in ('conv2_kernel', 'conv2_bias'):
        variables['params']['layer8'][name] *= PF_SCALE
    head, jhead = _heads(True, 2, True)
    jmodel = jassembled.AssembledModel(backbone=jax_backbone(), head=jhead)
    want, uniforms = _jax_predict(
        jmodel, {'params': {'backbone': variables['params']},
                 'batch_stats': {'backbone': variables['batch_stats']}},
        jbatch, monkeypatch)
    assert len(uniforms) == 2
    model = AssembledModel(
        RethinkingBackbone(target_keys=KEYS, variant='doubleline'), head)
    weights.load_state_dict(model.backbone,
                            weights.state_dict_from_jax(variables))
    model.eval()
    tbatch = tpipe._assemble_pairs(torch.from_numpy(images),
                                   torch.from_numpy(corners).long(),
                                   torch.from_numpy(delta).long(),
                                   _small_spec(tpipe))
    got = model.predict(tbatch, uniforms=uniforms)
    model.head = dataclasses.replace(head, dsac_predict_refine=False,
                                     dsac_predict_bidirectional=False)
    unrefined = model.predict(tbatch, uniforms=uniforms[0])
    assert np.abs(got.numpy() - unrefined.numpy()).max() > 1e-2, (
        'the knobs should move delta_hat')
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_build_model_takes_both_knobs():
    config = load_config(ZENG[0])
    config['MODEL']['HEAD'].update({'DSAC_PREDICT_REFINE': True,
                                    'DSAC_PREDICT_REFINE_ITERS': 3,
                                    'DSAC_PREDICT_BIDIRECTIONAL': True})
    head = build_model(config).head_cfg
    assert head.dsac_predict_refine and head.dsac_predict_bidirectional
    assert head.dsac_predict_refine_iters == 3
