"""The JAX side of the pretext-step tests: a batch built from injected draws
with the JAX package's own functions as ``tools/pretrain_aux.py:296-390``
builds it, and one step's loss, gradients and batch statistics composed as
``:405-453`` composes them (the tool's ``main`` is one closure; these are
its lines with the draws made outside). The port's side takes the same
draws through ``bihome_torch.pretrain_aux.make_batch``.

Small sizes: 128x128 pool images, patches of PS = 64 with rho 16, batch 2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from bihome_tpu import geometry as jgeo
from bihome_tpu.data import photometric as jphoto
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.data import synthetic as jsyn
from bihome_tpu.models.resnet import ResNet as JResNet
from bihome_tpu.ops import color as jcolor
from bihome_torch import pretrain_aux
from bihome_torch.models import weights
from bihome_torch.utils import aux_store
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_photometric import jax_photometric_params

import tools.pretrain_aux as tools

PS, RHO, BATCH, POOL = 64, 16, 2, 3
IMAGE_HW = (128, 128)


def pretext(name, **kw):
    return pretrain_aux.Pretext(name, patch_size=PS, rho=RHO, **kw)


def draws(p, seed=0):
    """(numpy draws, JAX photometric keys or None): the pool rows, the
    corners and integer deltas (patch centres as pipeline.draw_corners_
    delta_batch draws them), the rotations, the jitters, the crop origins,
    the basin jitters."""
    rs = np.random.RandomState(seed)
    h, w = IMAGE_HW
    out = {'idx': rs.randint(0, POOL, BATCH)}
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * BATCH)
    if p.name == 'gradpds':
        out['ox'] = rs.randint(0, w - PS + 1, BATCH)
        out['oy'] = rs.randint(0, h - PS + 1, BATCH)
        return out, keys[:BATCH]
    half = PS // 2
    pos = np.stack([rs.randint(RHO + half, w - RHO - half + 1, BATCH),
                    rs.randint(RHO + half, h - RHO - half + 1, BATCH)], -1)
    out['corners'] = np.stack([pos - half, pos + [half, -half], pos + half,
                               pos + [-half, half]], 1)
    out['delta'] = rs.randint(-RHO, RHO, (BATCH, 4, 2))
    out['rot'] = rs.randint(0, 4, BATCH)
    out['b'] = rs.uniform(-0.5, 0.5, BATCH).astype(np.float32)
    out['c'] = rs.uniform(0.6, 1.5, BATCH).astype(np.float32)
    out['s'] = rs.uniform(0.5, 4.0, BATCH).astype(np.float32)
    out['eps'] = rs.uniform(-1, 1, (BATCH, 4, 2)).astype(np.float32)
    return out, keys


def port_draws(p, d, keys):
    """The same draws as :func:`pretrain_aux.draw` lays them out."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    if p.name == 'gradpds':
        t['pd'] = jax_photometric_params(keys)
    if p.name == 'gradpdscl':
        t['pd1'] = jax_photometric_params(keys[:BATCH])
        t['pd2'] = jax_photometric_params(keys[BATCH:])
    return t


def pool():
    return jsyn.make_image_pool(POOL, *IMAGE_HW, seed=4)


def jax_batch(p, d, keys):
    """``make_batch`` / ``make_grad_batch`` / ``make_cl_batch`` on the
    injected draws."""
    images = jnp.asarray(pool()[d['idx']]).astype(jnp.float32)
    spec = jpipe.PairSpec(
        rho=RHO, patch_size=PS,
        photometric_keys=(('image_1', 'image_2') if p.name == 'gradpdscl'
                          else ()),
        max_delta=32.0 if p.name == 'gradpdscl' else 0.0)
    stride, out_dim = p.stride, p.out_dim
    if p.name == 'gradpds':
        rgb = jgeo.crop_integer(images, jnp.asarray(d['ox']),
                                jnp.asarray(d['oy']), (PS, PS))

        def std(g):
            return jcolor.standardize(g, spec.standardize_mean,
                                      spec.standardize_std)
        target = tools.grad_targets_pi(std(jcolor.rgb_to_grayscale(rgb)),
                                       stride=stride, out_dim=out_dim)
        distorted = jax.vmap(jphoto.photometric_distort_simple,
                             in_axes=(0, 0, None))(rgb, keys, 32.0)
        return {'x': std(jcolor.rgb_to_grayscale(distorted)),
                'target': target}
    batch = jpipe._assemble_pairs(images, jnp.asarray(d['corners']),
                                  jnp.asarray(d['delta']), keys[:BATCH],
                                  keys[BATCH:], spec)
    x = batch['patch_1']
    if p.name == 'rotnet':
        x90 = jnp.transpose(x[:, :, ::-1], (0, 2, 1, 3))
        x180 = x[:, ::-1, ::-1]
        x270 = jnp.transpose(x, (0, 2, 1, 3))[:, :, ::-1]
        stacked = jnp.stack([x, x90, x180, x270], axis=1)
        rot = jnp.asarray(d['rot'])
        return {'x': jnp.take_along_axis(
            stacked, rot[:, None, None, None, None], axis=1)[:, 0],
            'rot': rot}
    if p.name == 'gradpi':
        target = tools.grad_targets_pi(x, stride=stride, out_dim=out_dim)
        return {'x': jnp.asarray(d['c'])[:, None, None, None]
                * (x + jnp.asarray(d['b'])[:, None, None, None]),
                'target': target}
    if p.name == 'grad':
        return {'x': x, 'target': tools.grad_targets(x, stride=stride,
                                                     out_dim=out_dim)}
    x2 = batch['patch_2']
    w1, mask = tools.warp_gt(batch['patch_1'], batch['delta'])

    def tfn(v):
        if p.name == 'gradpdscl':
            return tools.grad_targets_pi(v, stride=stride, out_dim=out_dim)
        return tools.grad_targets(v, rich=p.rich_target, stride=stride,
                                  out_dim=out_dim)
    out = {'w1': w1, 'x2': x2,
           'valid': tools.nnavg_pool(mask, stride)[..., 0],
           't_w1': tfn(w1), 't_x2': tfn(x2)}
    if p.basin_weight > 0:
        eps = jnp.asarray(d['eps']) * jnp.asarray(d['s'])[:, None, None]
        w1e, maske = tools.warp_gt(batch['patch_1'], batch['delta'] + eps)
        out['w1e'] = w1e
        out['valide'] = tools.nnavg_pool(maske, stride)[..., 0]
    return out


def jax_model(p, dtype=jnp.float32, seed=0):
    """The tool's model (``:280``) and variables, its BN affines and
    statistics randomised (numpy). The whole resnet34 of rotnet has each
    block's last BN scale divided by 4, as ``tests/test_torch_resnet34.py``
    conditions it, so that its float32 batch-statistics backward is well
    conditioned."""
    model = JResNet(arch='resnet34', num_classes=4,
                    output_layer=p.output_layer, dtype=dtype)
    variables = randomize_variables(
        model.init(jax.random.PRNGKey(seed), jnp.zeros((2, PS, PS, 1)),
                   train=False), np.random.RandomState(seed))
    if p.output_layer is None:
        for name, block in variables['params'].items():
            if name.startswith('layer'):
                block['bn2']['scale'] = block['bn2']['scale'] / 4
    return model, variables


def jax_step(p, model, variables, batch):
    """``loss_fn`` (``:405-453``) on the batch: (loss, acc, gradients,
    new batch statistics), numpy."""
    batch_stats = variables['batch_stats']

    def loss_fn(params):
        if p.is_cl:
            views = [batch['w1'], batch['x2']] + (
                [batch['w1e']] if 'w1e' in batch else [])
            out, mut = model.apply(
                {'params': params, 'batch_stats': batch_stats},
                jnp.concatenate(views, axis=0), train=True,
                mutable=['batch_stats'])
            parts = jnp.split(out.astype(jnp.float32), len(views), axis=0)
            fw1, f2 = parts[0], parts[1]
            mse = 0.5 * (jnp.mean((fw1 - batch['t_w1']) ** 2)
                         + jnp.mean((f2 - batch['t_x2']) ** 2))
            nce, acc = tools.dense_infonce(fw1, f2, batch['valid'],
                                           tau=p.tau, rex=p.rex,
                                           hard_beta=p.cl_hard_beta)
            distill_w = 0.25 if p.name == 'gradpdscl' else 1.0
            loss = distill_w * mse + p.cl_weight * nce
            if 'w1e' in batch:
                ratio = tools.basin_ratio(fw1, parts[2], f2, batch['valid'],
                                          batch['valide'])
                loss = loss - p.basin_weight * ratio
                acc = ratio
            if p.cl_fine_weight > 0:
                nce_fine, _ = tools.dense_infonce(
                    fw1, f2, batch['valid'], tau=p.tau, rex=0,
                    hard_beta=p.cl_hard_beta)
                loss = loss + p.cl_fine_weight * nce_fine
            return loss, (mut['batch_stats'], acc)
        out, mut = model.apply({'params': params, 'batch_stats': batch_stats},
                               batch['x'], train=True,
                               mutable=['batch_stats'])
        if p.name.startswith('grad'):
            loss = jnp.mean((out.astype(jnp.float32) - batch['target']) ** 2)
            acc = 1.0 - loss / jnp.mean(batch['target'] ** 2)
        else:
            loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                out, batch['rot']))
            acc = jnp.mean((jnp.argmax(out, -1) == batch['rot'])
                           .astype(jnp.float32))
        return loss, (mut['batch_stats'], acc)

    (loss, (stats, acc)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    return jax.tree_util.tree_map(np.asarray, (loss, acc, grads, stats))


def port_model(p, variables, dtype=torch.float32):
    """The port's model of the pretext with the JAX variables."""
    model = pretrain_aux.build_model(p, dtype)
    state, _ = aux_store.state_dict_from_aux(variables, output_layer=4)
    weights.load_state_dict(model, state)
    return model


def as_port_names(tree, collection):
    """A flax ResNet tree of one collection -> the port's names (numpy)."""
    state, _ = aux_store.state_dict_from_aux(
        {collection: tree}, output_layer=4)
    return {k: v.numpy() for k, v in state.items()}
