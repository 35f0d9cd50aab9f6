"""``bihome_torch.eval --torch_ckpt`` reads a reference training checkpoint
as the JAX package's eval does (``eval.py:140-150`` ->
``bihome_tpu/models/torch_port.py:385-445``): the backbone and the
PerceptualHead's parts, the extractor ('1.resnet.', an RGB torchvision
stem), the projection head ('1.projection_head.') and the DSAC score CNN
('1.dsac.score_cnn.resnet18.').

The checkpoint is written from seeded tensors: a DoubleLine Rethinking
backbone (ResNet34 flavour, full width) with random BN statistics and its
PF head's output scaled so the field is a few pixels, the extractor's
conv1/bn1/layer1, one projection Linear, and a 2-channel resnet18 score
CNN with a 1-unit fc and random BN statistics. S-COCO zeng-biHomE cut to
32x32 patches (rho 8, 64x64 images, batch 2), 3 hypotheses scored by the
score CNN. JAX loads it with ``port_reference_checkpoint``, the port with
``eval.load_torch_checkpoint``; on the same DSAC draws the two predict
the same delta_hat within 1e-3 px (the port's predict tests' limit), the
extractor, the projection head and the score CNN hold JAX's values
(1e-6), and a model that leaves the score CNN at its init predicts
otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bihome_tpu import config as jconfig
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import dsac as jdsac
from bihome_tpu.models import torch_port
from bihome_torch import config as tconfig
from bihome_torch import eval as teval
from bihome_torch.data import pipeline as tpipe
from bihome_torch.models import backbones as tbb
from bihome_torch.models.resnet import ResNet
from tests.test_torch_datagen import ZENG, _injected, _small_spec
from tests.test_torch_train_step import _indices

N_HYP = 3


def _config(module):
    config = module.load_config(ZENG[0])
    config['MODEL']['HEAD'].update({
        'PATCH_SIZE': 32, 'RANSAC_HYPOTHESIS_NO': N_HYP,
        'SCORING_METHOD': 'score_cnn', 'WITH_PROJECTION_HEAD': [[64, 32]]})
    config['DATA']['TRANSFORMS'][0]['HomographyNetPrep'][:2] = [8, 32]
    return config


def _randomized(module, gen):
    """``module``'s state with seeded weights, BN statistics and affines."""
    tbb.init_weights(module, gen)
    state = {}
    for key, val in module.state_dict().items():
        if key.endswith('running_mean'):
            val = 0.1 * torch.randn(val.shape, generator=gen)
        elif key.endswith('running_var'):
            val = torch.rand(val.shape, generator=gen) * 0.5 + 0.75
        elif val.is_floating_point() and val.dim() == 1:
            val = val + 0.1 * torch.randn(val.shape, generator=gen)
        state[key] = val
    return state


def _reference_checkpoint(path):
    gen = torch.Generator().manual_seed(0)
    backbone = tbb.RethinkingBackbone(target_keys=('pf_hat_12', 'pf_hat_21'),
                                      variant='doubleline')
    state = {f'0.{k}': v for k, v in _randomized(backbone, gen).items()}
    for name in ('0.layer8.3.weight', '0.layer8.3.bias'):
        state[name] = state[name] * 0.5
    aux = ResNet('resnet34', output_layer=1, in_channels=3)
    state.update({f'1.resnet.{k}': v
                  for k, v in _randomized(aux, gen).items()})
    state['1.projection_head.0.weight'] = 0.1 * torch.randn((32, 64),
                                                            generator=gen)
    state['1.projection_head.0.bias'] = 0.1 * torch.randn(32, generator=gen)
    score = ResNet('resnet18', output_layer=None, in_channels=2,
                   num_classes=1)
    state.update({f'1.dsac.score_cnn.resnet18.{k}': v
                  for k, v in _randomized(score, gen).items()})
    torch.save({'model': state, 'step': 3}, path)
    return state


def test_reference_checkpoint_predicts_as_jax_loads_it(tmp_path,
                                                       monkeypatch):
    path = tmp_path / 'reference.pth'
    state = _reference_checkpoint(path)
    images, corners, delta = _injected(seed=6)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), keys, keys,
                                   _small_spec(jpipe))
    u = np.random.RandomState(1).uniform(0, 1, (2, N_HYP * 128)).astype(
        np.float32)
    monkeypatch.setattr(jdsac, 'sample_point_indices',
                        lambda key, shape, n, s: _indices(u, n))
    jconf = _config(jconfig)
    built = jconfig.build_model(jconf)
    rngs = {'params': jax.random.PRNGKey(1), 'dsac': jax.random.PRNGKey(2)}
    variables = jax.jit(built.model.init)(rngs, jbatch)
    variables, step = torch_port.port_reference_checkpoint(
        torch_port.load_torch_state_dict(str(path), full_checkpoint=True),
        jconf, {c: variables[c] for c in ('params', 'batch_stats')})
    assert step == 3
    want, _ = jax.jit(lambda v, b: built.model.apply(
        v, b, method='predict', rngs={'dsac': jax.random.PRNGKey(3)}))(
        variables, jbatch)

    tbuilt = tconfig.build_model(_config(tconfig))
    model = tbuilt.model
    assert teval.load_torch_checkpoint(model, str(path), 'Rethinking') == [
        'backbone', 'auxiliary_resnet', 'projection_head', 'score_cnn']
    model.eval()
    tbatch = tpipe._assemble_pairs(torch.from_numpy(images),
                                   torch.from_numpy(corners).long(),
                                   torch.from_numpy(delta).long(),
                                   _small_spec(tpipe))
    got = model.predict(tbatch, uniforms=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)

    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    np.testing.assert_allclose(
        model.auxiliary_resnet.conv1.weight.detach().numpy(),
        params['auxiliary_resnet']['conv1']['kernel'].transpose(3, 2, 0, 1),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        model.auxiliary_resnet.conv1.weight.detach().numpy(),
        state['1.resnet.conv1.weight'].sum(1, keepdim=True).numpy(),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        model.projection_head[0].weight.detach().numpy(),
        params['projection_0']['kernel'].T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        model.score_cnn.fc.weight.detach().numpy(),
        params['score_cnn']['fc']['kernel'].T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        model.score_cnn.layer4[1].bn2.running_var.numpy(),
        np.asarray(variables['batch_stats']['score_cnn']['layer4_1']['bn2'][
            'var']), rtol=0, atol=1e-6)

    # The score CNN decides which hypothesis predict takes.
    fresh = tconfig.build_model(_config(tconfig)).model
    fresh.backbone.load_state_dict(model.backbone.state_dict())
    tbb.init_weights(fresh.score_cnn, torch.Generator().manual_seed(5))
    other = fresh.eval().predict(tbatch, uniforms=torch.from_numpy(u))
    assert np.abs(other.numpy() - got.numpy()).max() > 1e-2
