"""The port's heads of the ResNet34 family (bihome_torch.heads.assembled)
and the tensor losses (bihome_torch.training.losses) against the JAX
package's ``AssembledModel.apply`` and ``compute_loss``.

The backbone is replaced on both sides by one that hands back the corner
deltas given in the batch, so the heads and losses are held on their own
with gradients w.r.t. those deltas. Pairs: 64x64 synthetic images, 32x32
patches, rho 8, batch 3, from the port's pair synthesis (the same inputs
go to both sides); deltas uniform in +-6 px, never integers.

* NoOpHead + MSELoss (detone-orig): the head's outputs exactly, loss and
  delta gradients 1e-6 relative.
* PhotometricHead + L1Loss (S-COCO nguyen-orig): warp-then-crop of the
  full standardized image_1 (the JAX side's CPU warp is a gather, whose
  derivative at integer coordinates differs from the port's convention,
  hence no integer coordinates). patch_hat 1e-4 absolute; loss 1e-5
  relative; delta gradients 1e-4 of their largest entry.
* PerceptualHead with DELTA_HAT_KEYS (detone-biHomE), the extractor from
  aux_clfbh.npz: loss and metrics 1e-4 relative, delta gradients 1e-4 of
  their largest entry.
* The four tensor losses, values and gradients: 1e-6.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from bihome_tpu.heads import AssembledModel as JModel
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_tpu.training import losses as jlosses
from bihome_tpu.utils import aux_store as jaux
from bihome_torch.config import load_config
from bihome_torch.data import pipeline as tpipe
from bihome_torch.heads.assembled import AssembledModel as TModel
from bihome_torch.heads.config import HeadConfig as THeadConfig
from bihome_torch.models import weights
from bihome_torch.training import losses as tlosses
from bihome_torch.utils import aux_store
from tests.test_torch_datagen import _injected

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {'detone-orig': 'config/s-coco/detone-orig-lr-5e-3.yaml',
           'nguyen-orig': 'config/s-coco/nguyen-orig-lr-5e-3.yaml',
           'detone-bihome': 'config/s-coco/detone-bihome-lr-5e-3.yaml'}
BATCH = 3


class JPass(fnn.Module):
    """JAX backbone that returns the deltas injected into the batch."""
    keys: tuple

    @fnn.compact
    def __call__(self, batch, train=False):
        return {k: batch[f'injected/{k}'] for k in self.keys}


class TPass(torch.nn.Module):
    """Port backbone that returns the deltas injected into the batch."""

    def __init__(self, keys):
        super().__init__()
        self.keys = keys

    def forward(self, batch):
        return {k: batch[f'injected/{k}'] for k in self.keys}


def _setup(name):
    config = load_config(CONFIGS[name])
    model_cfg = config['MODEL']
    keys = tuple(model_cfg['BACKBONE']['TARGET_KEYS'])
    jhead = dataclasses.replace(JHeadConfig.from_yaml(
        model_cfg['HEAD'], model_cfg['BACKBONE']), patch_size=32)
    thead = dataclasses.replace(THeadConfig.from_yaml(
        model_cfg['HEAD'], model_cfg['BACKBONE']), patch_size=32)
    emit = ('image_1',) if thead.name == 'PhotometricHead' else ()
    spec = dataclasses.replace(
        tpipe.PairSpec.from_transforms(config['DATA']['TRANSFORMS'], emit),
        patch_size=32, rho=8)
    images, corners, delta = _injected(seed=9, batch=BATCH)
    batch = tpipe._assemble_pairs(torch.from_numpy(images),
                                  torch.from_numpy(corners).long(),
                                  torch.from_numpy(delta).long(), spec)
    rs = np.random.RandomState(4)
    deltas = {k: rs.uniform(-6, 6, (BATCH, 4, 2)).astype(np.float32)
              for k in keys}
    return config['SOLVER']['LOSS'], keys, jhead, thead, batch, deltas


def _jax_side(name):
    loss_name, keys, jhead, _, batch, deltas = _setup(name)
    model = JModel(backbone=JPass(keys), head=jhead)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    variables = {}
    if jhead.name == 'PerceptualHead':
        aux = jaux.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz'))
        variables = {c: {'auxiliary_resnet': aux[c]}
                     for c in ('params', 'batch_stats')}

    def loss_fn(d):
        feed = {**jbatch, **{f'injected/{k}': v for k, v in d.items()}}
        out = model.apply(variables, feed, train=True)
        return jlosses.compute_loss(loss_name, out), out

    d = {k: jnp.asarray(v) for k, v in deltas.items()}
    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(d)
    return loss, out, grads


def _port_side(name):
    loss_name, keys, _, thead, batch, deltas = _setup(name)
    model = TModel(TPass(keys), thead).train()
    if model.auxiliary_resnet is not None:
        state, _ = aux_store.state_dict_from_aux(
            aux_store.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz')), 1)
        weights.load_state_dict(model.auxiliary_resnet, state)
    d = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in deltas.items()}
    out = model({**batch, **{f'injected/{k}': v for k, v in d.items()}})
    loss = tlosses.compute_loss(loss_name, out)
    loss.backward()
    predicted = model.predict({**batch, **{f'injected/{k}': v.detach()
                                           for k, v in d.items()}})
    return loss, out, {k: v.grad for k, v in d.items()}, predicted, deltas


def _rel(got, want, tol):
    want = np.asarray(want)
    scale = max(1e-12, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=0,
                               atol=tol)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_head_loss_and_delta_gradients_match_jax(name):
    jloss, jout, jgrads = _jax_side(name)
    tloss, tout, tgrads, predicted, deltas = _port_side(name)
    keys = list(deltas)
    # predict hands back the first direction's deltas.
    np.testing.assert_array_equal(predicted.numpy(), deltas[keys[0]])
    np.testing.assert_array_equal(tout['delta_hat'].detach().numpy(),
                                  deltas[keys[0]])
    np.testing.assert_array_equal(tout['delta_gt'].numpy(),
                                  np.asarray(jout['delta_gt']))
    if name == 'detone-orig':
        for key in ('ground_truth', 'network_output'):
            np.testing.assert_array_equal(tout[key].detach().numpy(),
                                          np.asarray(jout[key]))
        loss_tol, grad_tol = 1e-6, 1e-6
    elif name == 'nguyen-orig':
        assert tout['network_output'].shape == (BATCH, 32, 32, 1)
        np.testing.assert_allclose(tout['network_output'].detach().numpy(),
                                   np.asarray(jout['network_output']),
                                   rtol=0, atol=1e-4)
        loss_tol, grad_tol = 1e-5, 1e-4
    else:
        assert set(tout['metrics']) == set(jout['metrics'])
        for key, value in jout['metrics'].items():
            np.testing.assert_allclose(float(tout['metrics'][key]),
                                       float(value), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
        loss_tol, grad_tol = 1e-4, 1e-4
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=loss_tol,
                               atol=1e-7)
    for key in keys:
        assert float(np.abs(jgrads[key]).max()) > 0, key
        _rel(tgrads[key].numpy(), jgrads[key], grad_tol)


@pytest.mark.parametrize('loss_name', ['MSELoss', 'L1Loss', 'SmoothL1Loss',
                                       'CosineDistance'])
@pytest.mark.parametrize('ndim', [2, 4])
def test_tensor_loss_values_and_gradients_match_jax(loss_name, ndim):
    rs = np.random.RandomState(10 + ndim)
    shape = (3, 8) if ndim == 2 else (2, 4, 5, 6)
    gt = rs.randn(*shape).astype(np.float32)
    out = (gt + rs.randn(*shape) * 1.5).astype(np.float32)

    def jfn(o):
        return jlosses.compute_loss(loss_name, {
            'ground_truth': jnp.asarray(gt), 'network_output': o})
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    got = tlosses.compute_loss(loss_name, {
        'ground_truth': torch.from_numpy(gt), 'network_output': o})
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    _rel(o.grad.numpy(), want_g, 1e-6)
