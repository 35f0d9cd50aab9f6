"""The whole training slice of the port against the JAX step, and the
port's train CLI.

One zeng-biHomE training step (S-COCO config cut to 32x32 patches, rho 8,
batch 2, 64x64 images; DoubleLine Rethinking ResNet34 at full width; the
frozen extractor from ``aux_clfbh.npz``): injected pair draws -> backbone
in training mode -> DSAC both ways (the JAX draws injected) -> one warp of
both patches -> extractor -> fused triplet tail -> backward. The JAX side
is the ``loss_fn`` of ``bihome_tpu/training/trainer.py:62-79`` under
``jax.value_and_grad``, with ``bihome_tpu.heads.dsac.sample_point_indices``
monkeypatched in this test to take the injected uniforms. The port side
is ``bihome_torch.training.trainer.train_step``.

Backbone weights are the JAX init with random BN statistics and affines,
the last BN of each residual branch scaled by 1/4 (the conditioning note
in tests/test_torch_backbone.py) and the PF head's output conv scaled so
the field is a few pixels. Tolerances: loss and metrics rtol 1e-3 (the
DLT over 128 points amplifies the backbone's ~1e-5 relative float32
differences); the new BN statistics 1e-4; the frozen extractor bitwise
unchanged. Gradients: each tensor within 3e-2 relative L2 of JAX's, and
the median over tensors of (largest difference / largest entry) within
1e-2. They are held looser than in the per-module tests because the
network has ReLU inputs within float32 rounding of the kink (this setup
has one in layer7.0's residual branch), where two summation orders may
take different subgradients; one such flip moves every gradient a little
through the batch statistics, and the flipped layer's by percents. A
wrong rule or wiring moves them by their own size.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu import geometry as jgeo
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import dsac as jdsac
from bihome_tpu.training import losses as jlosses
from bihome_tpu.training import train_state as jts
from bihome_tpu.utils import aux_store as jaux
from bihome_torch import config as tconfig
from bihome_torch.models import weights
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_datagen import ZENG, _injected

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PF_SCALE = 0.03
BATCH = 2


def _small_config(module):
    config = module.load_config(ZENG[0])
    config['MODEL']['HEAD']['PATCH_SIZE'] = 32
    for transforms in (config['DATA']['TRANSFORMS'],):
        transforms[0]['HomographyNetPrep'][:2] = [8, 32]
    return config


def _draws(seed=11):
    rs = np.random.RandomState(seed)
    return [rs.uniform(0, 1, (BATCH, 128)).astype(np.float32)
            for _ in range(2)]


def _indices(u, n_points):
    """bihome_tpu.heads.dsac.sample_point_indices on given uniforms."""
    total = float((n_points - 1) * n_points)
    k = jnp.ceil((jnp.sqrt(1.0 + 4.0 * jnp.asarray(u) * total) - 1.0) / 2.0)
    return jnp.clip(k.astype(jnp.int32), 1, n_points - 1)


def _jax_variables(built, batch):
    variables = jax.jit(built.model.init)(
        {'params': jax.random.PRNGKey(0), 'dsac': jax.random.PRNGKey(1)},
        batch)
    rs = np.random.RandomState(2)
    backbone = randomize_variables({c: variables[c]['backbone']
                                    for c in ('params', 'batch_stats')}, rs)
    for name, block in backbone['params'].items():
        if not name.endswith('deconv') and 'upper_bn2' in block:
            block['upper_bn2']['scale'] = block['upper_bn2']['scale'] * 0.25
    for name in ('conv2_kernel', 'conv2_bias'):
        backbone['params']['layer8'][name] *= PF_SCALE
    aux = jaux.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz'))
    return {c: {'backbone': backbone[c], 'auxiliary_resnet': aux[c]}
            for c in ('params', 'batch_stats')}


@pytest.fixture(scope='module')
def step_outputs():
    """Both sides of one step; the JAX side's wall time is returned too."""
    start = time.perf_counter()
    jconf = _small_config(jconfig)
    built = jconfig.build_model(jconf)
    spec = built.pair_spec
    images, corners, delta = _injected(seed=6, batch=BATCH)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    batch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                  jnp.asarray(delta), keys, keys, spec)
    variables = _jax_variables(built, batch)
    u12, u21 = _draws()
    draws = iter([u12, u21])
    original = jdsac.sample_point_indices

    def injected(key, shape, n_points, point_sampling):
        assert point_sampling == 'reference-weighted'
        return _indices(next(draws), n_points)

    jdsac.sample_point_indices = injected
    try:
        def loss_fn(params):
            params = {k: (jax.lax.stop_gradient(v)
                          if k.startswith('auxiliary_resnet') else v)
                      for k, v in params.items()}
            out, mutated = built.model.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                batch, train=True, rngs={'dsac': jax.random.PRNGKey(5)},
                mutable=['batch_stats'])
            return jlosses.compute_loss(built.loss_name, out), (out, mutated)

        # Traced once under jit: the two DSAC calls take the injected
        # draws in order, 1->2 first.
        (loss, (out, mutated)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables['params'])
    finally:
        jdsac.sample_point_indices = original
    _, schedule = jts.make_optimizer(**jconfig.solver_kwargs(jconf))
    jmetrics = {'loss/train': loss, 'g_norm/value': optax.global_norm(grads),
                'lr/value': schedule(0),
                'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat'])}
    jmetrics.update(out['metrics'])
    jax_seconds = time.perf_counter() - start

    tbuilt = tconfig.build_model(_small_config(tconfig))
    model = tbuilt.model
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    aux_before = {k: v.clone()
                  for k, v in model.auxiliary_resnet.state_dict().items()}
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(tbuilt.config))
    tmetrics = trainer.train_step(
        model, opt, torch.from_numpy(images).to(torch.uint8),
        tbuilt.pair_spec, tbuilt.loss_name,
        corners=torch.from_numpy(corners), delta=torch.from_numpy(delta),
        uniforms=[torch.from_numpy(u) for u in (u12, u21)])
    to_np = jax.tree_util.tree_map(np.asarray, {
        'grads': grads['backbone'], 'stats': mutated['batch_stats']})
    return {'jax_metrics': {k: float(v) for k, v in jmetrics.items()},
            'port_metrics': {k: float(v) for k, v in tmetrics.items()},
            'jax': to_np, 'model': model, 'aux_before': aux_before,
            'jax_seconds': jax_seconds}


def test_train_step_loss_and_metrics_match_jax(step_outputs):
    want, got = step_outputs['jax_metrics'], step_outputs['port_metrics']
    assert set(got) == set(want)
    assert np.isfinite(got['loss/train'])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-5,
                                   err_msg=key)
    # The JAX reference's cost here, for the slow-marker decision.
    print(f"JAX side of the step fixture: {step_outputs['jax_seconds']:.1f} s")


def test_train_step_gradients_match_jax(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax({'params': step_outputs['jax']['grads']})
    params = dict(model.backbone.named_parameters())
    assert set(want) == set(params)
    rel_max = []
    for name, want_g in want.items():
        got = params[name].grad
        if name == 'layer8.0.bias':             # analytically 0
            assert got.abs().max() < 1e-3 and want_g.abs().max() < 1e-3
            continue
        l2 = float((got - want_g).norm() / want_g.norm())
        assert l2 < 3e-2, (name, l2)
        rel_max.append(float((got - want_g).abs().max() / want_g.abs().max()))
    assert np.median(rel_max) < 1e-2, np.median(rel_max)


def test_train_step_batch_stats_and_frozen_extractor(step_outputs):
    model = step_outputs['model']
    want = weights.state_dict_from_jax(
        {'params': {'backbone': {}}, 'batch_stats': step_outputs['jax']['stats']})
    buffers = dict(model.named_buffers())
    assert len(want) == 2 * 54
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name, value in model.auxiliary_resnet.state_dict().items():
        assert torch.equal(value, step_outputs['aux_before'][name]), name
    assert all(p.grad is None for p in model.auxiliary_resnet.parameters())


def _run_cli(args, cwd, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    return subprocess.run([sys.executable, '-m', *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_runs_on_cpu_and_eval_loads_its_checkpoint(tmp_path):
    log_dir = tmp_path / 'log'
    proc = _run_cli(['bihome_torch.train', '--config_file', ZENG[0],
                     '--synthetic', '--device', 'cpu', '--steps', '1',
                     '--batch_size', '2', '--epochs', '1',
                     '--set', f'LOGGING.DIR={log_dir}',
                     '--set', 'LOGGING.STEP=1',
                     '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz'],
                    cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert 'Auxiliary resnet (npz) loaded from aux_clfbh.npz' in proc.stdout
    import json
    lines = [json.loads(x) for x in
             (log_dir / 'metrics.jsonl').read_text().splitlines()]
    assert [x['step'] for x in lines] == [1, 1]
    for key in ('loss/train', 'g_norm/value', 'lr/value', 'mace/train',
                'loss_comp/ln1', 'h/h1'):
        assert np.isfinite(lines[0][key]), key
    assert set(lines[1]) == {'step', 'loss/test', 'mace/test'}
    ckpt = log_dir / 'model_000001.pth'
    state = torch.load(ckpt, weights_only=True)
    assert state['step'] == 1
    assert 'layer8.1.running_var' in {k[2:] for k in state['model']}
    proc = _run_cli(['bihome_torch.eval', '--config_file', ZENG[0],
                     '--synthetic', '--device', 'cpu', '--steps', '1',
                     '--batch_size', '2', '--torch_ckpt', str(ckpt)],
                    cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert 'Mean mace' in proc.stdout


def test_train_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from bihome_torch import train
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train.main(['--config_file', ZENG[0], '--synthetic', '--steps', '1'])
