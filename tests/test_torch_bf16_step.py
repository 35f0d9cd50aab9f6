"""The port's zeng-biHomE training step at bfloat16 against the JAX step at
bfloat16, and the train CLI's ``--dtype``.

The step is tests/test_torch_train_step.py's (S-COCO zeng-biHomE cut to
32x32 patches, rho 8, batch 2, 64x64 images, the DoubleLine Rethinking
ResNet34 at full width, the extractor from ``aux_clfbh.npz``, the JAX
draws injected, the conditioned random weights), with MODEL.DTYPE
bfloat16 on both sides: the bf16 warp source in the train spec, bf16
activations through the backbone, the fused decoder upsampling and the PF
head, the DSAC fit and the loss in float32. The JAX side is the CPU path:
its PF head is the unfused composition, which rounds ``a`` before the
ReLU and the output before adding b2, where the port (and the TPU's
Pallas kernels) round relu(a) and the output plus b2
(``bihome_tpu/models/backbones.py:74-94`` against
``bihome_tpu/ops/fused_head.py:93-107,283``).

Limits. On the forward prediction (delta_hat, 1->2) and on the loss
(its error measured on the sum of its terms' magnitudes, ln1 + ln2 + mu
ln3) the port at bf16 must stand closer to JAX at bf16 than JAX at
float32 does: the rounding falls where JAX's does. The backbone's
gradients are held to the spread of two legitimate bf16 roundings (see
that test), which JAX's float32 gradients pass too; absolute limits of
2e-2 on the loss and 5e-2 on the gradients are out of reach of any second
implementation of this step at bf16: JAX's own float32 step stands 0.11
(loss / terms) and 0.43 (gradients) from its bf16 one. The step from the
PF head's input on, that input handed to both sides, tells the rounding
apart: there the port stands within half of JAX float32's distance from
JAX bf16 (readings 2.8e-2 against 0.27 on the loss, 0.108 against 0.438
on the head's and its input's gradients).

Every other config builds at bf16 and takes one finite CPU train step;
a config refused at float32 is refused at bf16 by the same message.
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import dsac as jdsac
from bihome_tpu.models import backbones as jbackbones
from bihome_tpu.training import losses as jlosses
from bihome_torch import config as tconfig
from bihome_torch.models import weights
from bihome_torch.training import losses as tlosses
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.test_torch_datagen import ZENG, _injected
from tests.test_torch_train_step import (BATCH, REPO, _draws, _indices,
                                         _jax_variables, _run_cli,
                                         _small_config)


def _config(module, dtype):
    config = _small_config(module)
    config['MODEL']['DTYPE'] = dtype
    return config


def _jax_step(dtype, images, corners, delta, draws, variables=None):
    """(loss, the sum of its terms' magnitudes, delta_hat (1->2), the
    backbone's gradients in the port's layout, variables) of JAX's step at
    ``dtype`` on the injected pairs and DSAC draws."""
    built = jconfig.build_model(_config(jconfig, dtype))
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    batch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                  jnp.asarray(delta), keys, keys,
                                  built.pair_spec)
    if variables is None:
        variables = _jax_variables(built, batch)
    it = iter(draws)
    original = jdsac.sample_point_indices

    def injected(key, shape, n_points, point_sampling):
        return _indices(next(it), n_points)

    jdsac.sample_point_indices = injected
    try:
        def loss_fn(params):
            params = {k: (jax.lax.stop_gradient(v)
                          if k.startswith('auxiliary_resnet') else v)
                      for k, v in params.items()}
            out, _ = built.model.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                batch, train=True, rngs={'dsac': jax.random.PRNGKey(5)},
                mutable=['batch_stats'])
            terms = sum(jnp.abs(out['metrics'][f'loss_comp/ln{i}'])
                        for i in (1, 2, 3))
            return (jlosses.compute_loss(built.loss_name, out),
                    (out['delta_hat'], terms))

        (loss, (deltas, terms)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables['params'])
    finally:
        jdsac.sample_point_indices = original
    return (float(loss), float(terms), np.asarray(deltas, np.float32),
            weights.state_dict_from_jax({'params': jax.tree_util.tree_map(
                np.asarray, grads['backbone'])}), variables)


@pytest.fixture(scope='module')
def steps():
    images, corners, delta = _injected(seed=6, batch=BATCH)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    draws = _draws()
    loss16, terms, d16, g16, variables = _jax_step(
        'bfloat16', images, corners, delta, draws)
    loss32, _, d32, g32, _ = _jax_step('float32', images, corners, delta,
                                       draws, variables)

    built = tconfig.build_model(_config(tconfig, 'bfloat16'))
    assert built.dtype == torch.bfloat16
    assert built.pair_spec.warp_dtype == 'bfloat16'
    assert built.test_pair_spec.warp_dtype == 'float32'
    model = built.model
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(built.config))
    deltas = []
    original = model.dsac_both

    def keep(*args, **kwargs):
        out = original(*args, **kwargs)
        deltas.append(out[0].detach())
        return out

    model.dsac_both = keep
    metrics = trainer.train_step(
        model, opt, torch.from_numpy(images).to(torch.uint8),
        built.pair_spec, built.loss_name,
        corners=torch.from_numpy(corners), delta=torch.from_numpy(delta),
        uniforms=[torch.from_numpy(u) for u in draws])
    return {'jax16': (loss16, d16, g16), 'jax32': (loss32, d32, g32),
            'terms': terms,
            'port': (float(metrics['loss/train']), deltas[0].numpy()),
            'model': model, 'variables': variables,
            'inputs': (images, corners, delta, draws)}


def test_bf16_step_loss_and_prediction_sit_with_jax_bf16(steps):
    loss16, d16, _ = steps['jax16']
    loss32, d32, _ = steps['jax32']
    loss, d = steps['port']
    assert np.isfinite(loss) and d.dtype == np.float32
    terms = steps['terms']
    loss_err = abs(loss - loss16) / terms
    loss_err32 = abs(loss32 - loss16) / terms
    d_err = np.linalg.norm(d - d16) / np.linalg.norm(d16)
    d_err32 = np.linalg.norm(d32 - d16) / np.linalg.norm(d16)
    print(f'loss: port bf16 {loss:.6f}, JAX bf16 {loss16:.6f}, JAX f32 '
          f'{loss32:.6f} (terms {terms:.4f}); error / terms: port '
          f'{loss_err:.2e}, JAX f32 {loss_err32:.2e}. delta_hat relative L2 '
          f'to JAX bf16: port {d_err:.2e}, JAX f32 {d_err32:.2e}')
    assert loss_err < loss_err32 and d_err < d_err32


def _flat(grads, names):
    return torch.cat([grads[n].flatten() for n in names])


def test_bf16_step_gradients_sit_with_jax_bf16(steps):
    """The backbone's gradients against JAX's at bf16, held to the spread
    of two legitimate roundings of this step: within 1.5 times the distance
    of JAX's own float32 gradients from its bf16 ones. (A one-ulp flip of a
    bf16 activation, which another float32 summation order causes, reaches
    hundreds of sums in the next convolution and flips some of those in
    turn; through the 50 batch-statistics layers of this random network the
    two sides' gradients decorrelate to the size of bf16 rounding noise, as
    JAX's float32 ones do from its bf16 ones: 0.43 relative L2.)"""
    model = steps['model']
    want, want32 = steps['jax16'][2], steps['jax32'][2]
    params = dict(model.backbone.named_parameters())
    assert set(want) == set(params)
    names = [n for n in want if n != 'layer8.0.bias']  # analytically 0
    got = {n: params[n].grad for n in names}
    assert all(g.dtype == torch.float32 for g in got.values())
    per = {n: float((got[n] - want[n]).norm() / want[n].norm())
           for n in names}
    l2 = float((_flat(got, names) - _flat(want, names)).norm()
               / _flat(want, names).norm())
    l2_32 = float((_flat(want32, names) - _flat(want, names)).norm()
                  / _flat(want, names).norm())
    worst = max(per, key=per.get)
    print(f'bf16 step gradients against JAX bf16: relative L2 over all '
          f'tensors {l2:.2e} (JAX f32: {l2_32:.2e}), worst tensor '
          f'{per[worst]:.2e} ({worst}), median '
          f'{np.median(list(per.values())):.2e}')
    assert l2 <= 1.5 * l2_32


def _tail_grads(grads, x_grad):
    """{name: float64 tensor} of the PF head's parameter gradients (torch
    layout, layer8.0.bias left out: 0 analytically) and of its input
    (NHWC)."""
    out = {n: torch.as_tensor(np.asarray(g, np.float64))
           for n, g in grads.items()
           if n.startswith('layer8.') and n != 'layer8.0.bias'}
    out['input'] = torch.as_tensor(np.asarray(x_grad, np.float64))
    return out


def _port_tail(built, variables, batch, draws, x):
    """(loss, its terms' magnitudes, _tail_grads) of the port's step with
    the PF head's input replaced by ``x`` (NCHW, in the model's dtype)."""
    model = built.model.train()
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    leaf = x.to(built.dtype).clone().requires_grad_(True)
    hook = model.backbone.layer8.register_forward_pre_hook(
        lambda module, args: (leaf,) + tuple(args[1:]))
    try:
        out = model(batch, uniforms=[torch.from_numpy(u) for u in draws])
    finally:
        hook.remove()
    loss = tlosses.compute_loss(built.loss_name, out)
    loss.backward()
    terms = sum(abs(float(out['metrics'][f'loss_comp/ln{i}']))
                for i in (1, 2, 3))
    grads = {n: p.grad for n, p in model.backbone.named_parameters()
             if p.grad is not None}
    return float(loss), terms, _tail_grads(
        grads, leaf.grad.float().permute(0, 2, 3, 1))


def _jax_tail(dtype, variables, batch, draws, x):
    """The same on JAX's step at ``dtype``: the PF head's input replaced
    through ``flax.linen.intercept_methods``."""
    built = jconfig.build_model(_config(jconfig, dtype))
    it = iter(draws)
    original = jdsac.sample_point_indices
    jdsac.sample_point_indices = (
        lambda key, shape, n_points, point_sampling:
        _indices(next(it), n_points))

    def loss_fn(params, xi):
        def replace_input(next_fun, args, kwargs, context):
            if (isinstance(context.module, jbackbones.PFHead)
                    and context.method_name == '__call__'):
                args = (xi,) + tuple(args[1:])
            return next_fun(*args, **kwargs)
        params = {k: (jax.lax.stop_gradient(v)
                      if k.startswith('auxiliary_resnet') else v)
                  for k, v in params.items()}
        with flax.linen.intercept_methods(replace_input):
            out, _ = built.model.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                batch, train=True, rngs={'dsac': jax.random.PRNGKey(5)},
                mutable=['batch_stats'])
        terms = sum(jnp.abs(out['metrics'][f'loss_comp/ln{i}'])
                    for i in (1, 2, 3))
        return jlosses.compute_loss(built.loss_name, out), terms

    xj = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(dtype)
    try:
        (loss, terms), (gp, gx) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(variables['params'], xj)
    finally:
        jdsac.sample_point_indices = original
    grads = weights.state_dict_from_jax({'params': jax.tree_util.tree_map(
        np.asarray, gp['backbone'])})
    return float(loss), float(terms), _tail_grads(
        grads, np.asarray(gx.astype(jnp.float32)))


def _tail_errors(got, want):
    """(loss error / the reference's terms, the gradients' relative L2
    over all tensors)."""
    flat = torch.cat([got[2][n].flatten() for n in want[2]])
    flat_ref = torch.cat([g.flatten() for g in want[2].values()])
    return (abs(got[0] - want[0]) / want[1],
            float((flat - flat_ref).norm() / flat_ref.norm()))


def test_bf16_step_from_the_heads_input_sits_with_jax_bf16(steps):
    """The step from the PF head's input on (the head, the DSAC fit, the
    warps, the frozen extractor, the loss), the input the port's own bf16
    backbone computed, the pairs JAX's bf16 datagen made, handed to both
    sides. Past the backbone's depth the rounding points show: the port
    at bf16 stands within half of JAX float32's distance from JAX bf16,
    on the loss and on the gradients of the head's parameters and input."""
    images, corners, delta, draws = steps['inputs']
    variables = steps['variables']
    spec = jconfig.build_model(_config(jconfig, 'bfloat16')).pair_spec
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    jbatch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                   jnp.asarray(delta), keys, keys, spec)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    built = tconfig.build_model(_config(tconfig, 'bfloat16'))
    weights.load_state_dict(built.model,
                            weights.state_dict_from_jax(variables))
    recorded = []
    hook = built.model.backbone.layer8.register_forward_pre_hook(
        lambda module, args: recorded.append(args[0].detach().clone()))
    with torch.no_grad():
        built.model.train()(batch, uniforms=[torch.from_numpy(u)
                                             for u in draws])
    hook.remove()
    x = recorded[0]
    assert x.dtype == torch.bfloat16 and len(recorded) == 1

    port = _port_tail(built, variables, batch, draws, x)
    jax16 = _jax_tail('bfloat16', variables, jbatch, draws, x)
    jax32 = _jax_tail('float32', variables, jbatch, draws, x)
    (loss_err, l2), (loss_err32, l2_32) = (_tail_errors(port, jax16),
                                           _tail_errors(jax32, jax16))
    print(f'from the PF head\'s input {list(x.shape)}, against JAX bf16: '
          f'port bf16 loss error / terms {loss_err:.2e}, gradients relative '
          f'L2 {l2:.2e}; JAX f32 {loss_err32:.2e}, {l2_32:.2e}')
    assert loss_err <= 0.5 * loss_err32 and l2 <= 0.5 * l2_32


def test_train_cli_trains_at_bfloat16_on_cpu(tmp_path):
    log_dir = tmp_path / 'log'
    proc = _run_cli(['bihome_torch.train', '--config_file', ZENG[1],
                     '--synthetic', '--device', 'cpu', '--steps', '1',
                     '--batch_size', '2', '--epochs', '1', '--dtype',
                     'bfloat16', '--set', f'LOGGING.DIR={log_dir}',
                     '--set', 'LOGGING.STEP=1'], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert 'compute dtype bfloat16' in proc.stdout
    import json
    first = json.loads((log_dir / 'metrics.jsonl').read_text().splitlines()[0])
    assert np.isfinite(first['loss/train'])
    # The checkpoint is float32 and loads into a float32 model.
    state = torch.load(log_dir / 'model_000001.pth', weights_only=True)
    floats = [v for v in state['model'].values() if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)
    proc = _run_cli(['bihome_torch.eval', '--config_file', ZENG[0],
                     '--synthetic', '--device', 'cpu', '--steps', '1',
                     '--batch_size', '2', '--torch_ckpt',
                     str(log_dir / 'model_000001.pth')], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert 'Mean mace' in proc.stdout


# The configs beyond bench.py's four and their S-COCO twins (R50 zeng's
# Cin 64 head, zeng-orig, the PhotometricHead, the biHomE loss on
# regressed deltas, CLEVR-Change pairs): each builds at bf16 and takes one
# CPU train step (batch 2, 32x32 patches, rho 8, 64x64 synthetic images;
# CLEVR-Change 64x48 change pairs) with a finite loss.
BF16_CONFIGS = {
    'r50': (ZENG[0], ('MODEL.BACKBONE.RESNET_BLOCK=ResNet50',)),
    'zeng-orig': ('config/pds-coco/zeng-orig-lr-1e-3.yaml', ()),
    's-coco-nguyen-orig': ('config/s-coco/nguyen-orig-lr-5e-3.yaml', ()),
    'pds-detone-bihome': ('config/pds-coco/detone-bihome-lr-5e-3.yaml', ()),
    'pds-zhang-bihome': ('config/pds-coco/zhang-bihome-lr-1e-2.yaml', ()),
    'clevr-change': ('config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml', ())}


def _bf16_config(path, sets):
    config = tconfig.load_config(os.path.join(REPO, path))
    tconfig.apply_overrides(config, list(sets))
    config['MODEL']['HEAD']['PATCH_SIZE'] = 32
    for key in ('TRANSFORMS', 'TEST_TRANSFORM'):
        prep = config['DATA'].get(key, [{}])[0].get('HomographyNetPrep')
        if prep:
            prep[:2] = [8, 32]
    return config


@pytest.mark.parametrize('name', sorted(BF16_CONFIGS))
def test_build_model_trains_every_config_at_bf16(name):
    from bihome_torch.data import clevr_change, synthetic
    from bihome_torch.models import backbones
    path, sets = BF16_CONFIGS[name]
    built = tconfig.build_model(_bf16_config(path, sets), dtype='bfloat16')
    assert built.dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    backbones.init_weights(built.model.backbone, gen)
    if built.pair_spec.change_aware_keys:
        ds = clevr_change.SyntheticChangeDataset(num_images=2,
                                                 image_size=(64, 48))
        images = torch.from_numpy(np.stack([
            np.stack([ds.load_image(i), ds.load_image(i + 2)])
            for i in range(2)]))
    else:
        images = torch.from_numpy(synthetic.make_image_pool(2, 64, 64))
    opt = Optimizer([p for p in built.model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(built.config))
    metrics = trainer.train_step(built.model, opt, images, built.pair_spec,
                                 built.loss_name, datagen_generator=gen,
                                 dsac_generator=gen)
    assert np.isfinite(float(metrics['loss/train']))


def test_build_model_refuses_at_bf16_what_it_refuses_at_float32():
    config = _bf16_config(ZENG[0], ('MODEL.HEAD.NAME=SomeHead',))
    messages = []
    for dtype in ('float32', 'bfloat16'):
        with pytest.raises(ValueError, match='not ported yet') as err:
            tconfig.build_model(config, dtype=dtype)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
