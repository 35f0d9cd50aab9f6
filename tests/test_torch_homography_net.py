"""The port's HomographyNetBackbone (``bihome_torch.models.backbones``)
against the JAX package's (``bihome_tpu/models/backbones.py:339-370``),
with the JAX weights carried across by ``weights.state_dict_from_jax``,
and a reference HomographyNet checkpoint read by both packages.

* Forward and gradients, random BN statistics and affines: at
  IMAGE_SIZE 128 (batch 2) in training mode (batch statistics) in
  float64 on both sides (JAX under ``enable_x64``, as
  tests/test_torch_rethinking_r50.py holds its gradients): the corner
  deltas within 1e-4 of their largest entry, the updated running
  statistics within 1e-5 (atol; rtol 1e-4), each parameter's gradient
  within 1e-4 of its largest entry. At 512 (batch 1, the 12-layer
  layout) in eval mode in float32: the deltas within 1e-4 of their
  largest entry, each gradient within 1e-2 relative L2 (read: at most
  5.0e-3; in float64 the two sides agree to 2.5e-8, and a float64 run
  at 512 costs 40 s here). In float32 the two sides' gradients stand
  apart for rounding alone: in training mode by 1-3% of the largest
  entry in the first layers (eight or twelve batch-statistics BNs
  between them and the output), and at 512 in eval mode by ~0.4% in
  every layer up to the eighth (its conv's gradient and not its BN's:
  ReLU comes before BN, so the ReLU's zeros leave exact ties in the 2x2
  max-pool after it, and a conv output within rounding of 0 decides
  which tap takes the gradient). The float32 training-mode forward is
  held at 128 (1e-4 of the largest delta). The fc1 kernel reads the
  16x16x128 map in flax's NHWC order; a CHW flatten would fail all of
  these.
* A reference-layout state dict (``layerK.{0,2}``, ``fc1.0`` over the
  CHW flatten, ``fc2``) from seeded tensors, written as a training checkpoint
  {'model': {'0.*': ...}}: JAX's ``torch_port.port_homography_net`` and
  the port's ``eval --torch_ckpt`` loader give the same eval-mode
  prediction, within 1e-4 of its largest entry; the eval CLI runs it.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models import backbones as jbb
from bihome_tpu.models import torch_port
from bihome_torch import eval as teval
from bihome_torch.models import backbones as tbb
from bihome_torch.models import weights
from tests.test_torch_backbone import randomize_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = 'delta_hat_12'
# IMAGE_SIZE -> (batch, seed, training mode)
SIZES = {128: (2, 0, True), 512: (1, 1, False)}


def _patches(size, batch, rs):
    return {k: rs.randn(batch, size, size, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}


def _jax_net(size, dtype=jnp.float32):
    return jbb.HomographyNetBackbone(target_keys=(KEY,), image_size=size,
                                     dtype=dtype)


@pytest.mark.parametrize('size', list(SIZES))
def test_forward_and_gradients_match_flax(size):
    batch, seed, train = SIZES[size]
    dtype = np.float64 if train else np.float32
    rs = np.random.RandomState(seed)
    data = {k: v.astype(dtype) for k, v in _patches(size, batch, rs).items()}
    g = rs.randn(batch, 4, 2).astype(dtype)
    with jax.enable_x64(train):
        net = _jax_net(size, dtype)
        jdata = {k: jnp.asarray(v) for k, v in data.items()}
        variables = randomize_variables(
            jax.jit(net.init)(jax.random.PRNGKey(seed), jdata), rs)
        variables = jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                           variables)

        def loss(params):
            out, mutated = net.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                jdata, train=train, mutable=['batch_stats'])
            return jnp.sum(out[KEY] * g), (out[KEY], mutated)
        (_, (want, mutated)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables['params'])
        to_np = jax.tree_util.tree_map(np.asarray, {
            'params': grads, 'batch_stats': mutated['batch_stats']})
        want = np.asarray(want)

    model = tbb.HomographyNetBackbone(target_keys=(KEY,), image_size=size)
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    model = model.to(torch.float64 if train else torch.float32).train(train)
    got = model({k: torch.from_numpy(v) for k, v in data.items()})[KEY]
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    buffers = dict(model.named_buffers())
    want_stats = weights.state_dict_from_jax(
        {'params': {}, 'batch_stats': to_np['batch_stats']})
    assert len(want_stats) == 2 * (8 if size == 128 else 12)
    if not train:
        want_stats = {k: torch.from_numpy(np.asarray(v, np.float32))
                      for k, v in weights.state_dict_from_jax(
                          variables).items() if 'running' in k}
    for name, value in want_stats.items():
        np.testing.assert_allclose(buffers[name].float().numpy(),
                                   value.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    want_g = weights.state_dict_from_jax({'params': to_np['params']})
    params = dict(model.named_parameters())
    assert set(want_g) == set(params)
    for name, w in want_g.items():
        got_g = params[name].grad.float()
        if train:
            np.testing.assert_allclose(got_g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * w.abs().max().item(),
                                       err_msg=name)
        else:
            assert float((got_g - w).norm() / w.norm()) < 1e-2, name


def test_float32_train_forward_matches_flax():
    rs = np.random.RandomState(2)
    data = _patches(128, 2, rs)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    net = _jax_net(128)
    variables = randomize_variables(
        jax.jit(net.init)(jax.random.PRNGKey(2), jdata), rs)
    want, _ = jax.jit(lambda v: net.apply(v, jdata, train=True,
                                          mutable=['batch_stats']))(variables)
    want = np.asarray(want[KEY])
    model = tbb.HomographyNetBackbone(target_keys=(KEY,), image_size=128)
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    got = model.train()({k: torch.from_numpy(v)
                         for k, v in data.items()})[KEY]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _reference_state(seed=3):
    """A reference HomographyNet state dict at IMAGE_SIZE 128: conv
    weights and biases, BN affines and statistics, fc1 over the CHW
    flatten of the last map, fc2; from seeded tensors."""
    gen = torch.Generator().manual_seed(seed)
    ref = tbb.HomographyNetBackbone(image_size=128)
    state = {}
    for key, val in ref.state_dict().items():
        if key.endswith('num_batches_tracked'):
            state[key] = val
        elif key.endswith('running_var'):
            state[key] = torch.rand(val.shape, generator=gen) * 0.5 + 0.75
        elif key.endswith('.2.weight'):
            state[key] = 1.0 + 0.1 * torch.randn(val.shape, generator=gen)
        elif val.dim() > 1:
            fan_in = val[0].numel()
            state[key] = torch.randn(val.shape, generator=gen) / fan_in ** 0.5
        else:
            state[key] = 0.1 * torch.randn(val.shape, generator=gen)
    return state


def test_reference_checkpoint_loads_as_jax_ports_it(tmp_path):
    state = _reference_state()
    path = tmp_path / 'homography_net.pth'
    torch.save({'model': {f'0.{k}': v for k, v in state.items()},
                'step': 7}, path)
    # JAX's reader takes a BN field from the fourth part of the key
    # (torch_port.py:354), which the Seq(Conv, ReLU, BN) key
    # 'layerK.2.weight' has third: it is handed 'layerK.2.bn.weight'.
    ported = torch_port.port_homography_net(
        {re.sub(r'^(layer\d+)\.2\.', r'\1.2.bn.', k): v.numpy()
         for k, v in state.items()}, 128)
    rs = np.random.RandomState(4)
    data = _patches(128, 2, rs)
    want = np.asarray(_jax_net(128).apply(
        ported, {k: jnp.asarray(v) for k, v in data.items()})[KEY])

    from bihome_torch.heads.assembled import AssembledModel
    from bihome_torch.heads.config import HeadConfig
    model = AssembledModel(
        tbb.HomographyNetBackbone(target_keys=(KEY,), image_size=128),
        HeadConfig(name='NoOpHead'))
    assert teval.load_torch_checkpoint(model, str(path),
                                       'HomographyNet') == ['backbone']
    model.eval()
    got = model.backbone({k: torch.from_numpy(v)
                          for k, v in data.items()})[KEY]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # The CHW flatten read as HWC gives another prediction.
    plain = tbb.HomographyNetBackbone(target_keys=(KEY,), image_size=128)
    plain.load_state_dict(state)
    other = plain.eval()({k: torch.from_numpy(v)
                          for k, v in data.items()})[KEY]
    assert np.abs(other.detach().numpy() - want).max() > 1e-2


def test_eval_cli_reads_a_reference_homography_net_checkpoint(tmp_path):
    path = tmp_path / 'homography_net.pth'
    torch.save({'model': {f'0.{k}': v
                          for k, v in _reference_state().items()}}, path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run(
        [sys.executable, '-m', 'bihome_torch.eval', '--config_file',
         'config/s-coco/detone-orig-lr-5e-3.yaml', '--device', 'cpu',
         '--synthetic', '--steps', '1', '--batch_size', '2',
         '--set', 'MODEL.BACKBONE.NAME=HomographyNet',
         '--torch_ckpt', str(path), '--skip_timing'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(': ', 1) for line in proc.stdout.splitlines()
                 if ': ' in line)
    assert 'Loaded reference torch checkpoint (backbone)' in proc.stdout
    assert int(lines['Number of params']) == sum(
        v.numel() for k, v in _reference_state().items()
        if not k.endswith(('running_mean', 'running_var',
                           'num_batches_tracked')))
    assert np.isfinite(float(lines['Mean mace']))
