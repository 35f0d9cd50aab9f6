"""One data-parallel training step of the port on 2 gloo ranks against the
port's one-process step and JAX's step at the same global batch, and the
``--pool_shard`` draws.

The step is tests/test_torch_train_step.py's zeng-biHomE (S-COCO config
cut to 32x32 patches and rho 8 on 64x64 images; DoubleLine Rethinking
ResNet34; DSAC both ways, 128 points; the biHomE loss with the frozen
extractor from ``aux_clfbh.npz``; Adam), at global batch 4 with injected
pair and DSAC draws. Each rank takes its 2 samples; the batch norms and
the PF head normalise by all 4, the gradients are summed over the ranks
(the biHomE loss sums over the batch). JAX's one-device step stands in
for its 2-device ``compile_for_mesh`` step, which
tests/test_trainer.py:100-139 holds equal to it. The same step with
PDS-COCO's photometric distortion and nothing injected (the trainer's own
draws from seeded generators, each rank keeping its rows of the global
batch's) holds 2 ranks to one process on every logged metric, the
gradients and the running statistics.

Tolerances. 2 ranks against one process, both float32 with the same
draws, differ only in summation order: the loss within 2e-4 of the sum
of its terms' magnitudes (ln1 + ln2 + mu*ln3 largely cancel, and each is
itself a difference of feature distances; 6.4e-5 seen), MACE rtol 1e-5;
gradients 1e-4 relative L2 over all tensors and 2e-3 for each tensor; the
running
statistics 1e-5; equal on both ranks. Against JAX, as the one-process
test holds the port: the loss within 1e-3 of its terms' magnitudes, MACE
rtol 1e-3, each gradient tensor 3e-2
relative L2 and the median of (largest difference / largest entry) 1e-2
(ReLU inputs within float32 rounding of the kink); the parameters after
Adam atol 2.5e-3 (JAX's own bound for its mesh step, tests/
test_trainer.py:132-139); the running statistics 1e-4.
"""

import dataclasses

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
from bihome_torch import config as tconfig
from bihome_torch.models import weights
from tests import torch_dist_helpers as h
from tests.test_torch_datagen import _injected
from tests.test_torch_train_step import (_indices, _jax_variables,
                                         _small_config)

BATCH = 4
DRAW_SEED = 31


def _distorted_config():
    """The small config with PDS-COCO's photometric distortion (max delta
    32), so that the drawn step draws corners, deltas, both copies'
    distortion and the DSAC uniforms of both fields."""
    config = _small_config(tconfig)
    config['DATA']['TRANSFORMS'][0]['HomographyNetPrep'][3] = 32
    return config


def _jax_step(built, config, images, corners, delta, uniforms):
    """JAX's loss, metrics, backbone gradients, backbone parameters after
    Adam and new batch statistics, the DSAC draws injected."""
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    batch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                  jnp.asarray(delta), keys, keys,
                                  built.pair_spec)
    variables = _jax_variables(built, batch)
    draws = iter(uniforms)
    original = jdsac.sample_point_indices
    jdsac.sample_point_indices = (
        lambda key, shape, n_points, sampling: _indices(next(draws),
                                                        n_points))
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
        (loss, (out, mutated)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables['params'])
    finally:
        jdsac.sample_point_indices = original
    tx, _ = jts.make_optimizer(**jconfig.solver_kwargs(config))
    backbone = {'backbone': variables['params']['backbone']}
    bgrads = {'backbone': grads['backbone']}
    updates, _ = tx.update(bgrads, tx.init(backbone), backbone)
    new = optax.apply_updates(backbone, updates)
    metrics = {'loss/train': loss,
               'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat'])}
    return variables, jax.tree_util.tree_map(np.asarray, {
        'metrics': metrics, 'grads': grads['backbone'],
        'params': new['backbone'], 'stats': mutated['batch_stats']})


@pytest.fixture(scope='module')
def steps():
    jconf = _small_config(jconfig)
    built = jconfig.build_model(jconf)
    images, corners, delta = _injected(seed=7, batch=BATCH)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    rs = np.random.RandomState(13)
    uniforms = [rs.uniform(0, 1, (BATCH, 128)).astype(np.float32)
                for _ in range(2)]
    variables, jax_out = _jax_step(built, jconf, images, corners, delta,
                                   uniforms)
    state = {k: v.numpy() for k, v in
             weights.state_dict_from_jax(variables).items()}
    args = (_small_config(tconfig), state, images, corners.astype(np.int64),
            delta.astype(np.int64), uniforms)
    drawn = (_distorted_config(), state, images, DRAW_SEED)
    ranks = h.run_ranks(h.ddp_step_worker, 2, args, drawn)
    return {'one': h.one_step(*args), 'ranks': [r['injected'] for r in ranks],
            'jax': jax_out,
            'one_drawn': h.one_step(*drawn[:3], None, None, None, DRAW_SEED),
            'ranks_drawn': [r['drawn'] for r in ranks]}


def _from_jax(tree, kind):
    """A JAX backbone tree as the port's backbone names (numpy)."""
    state = weights.state_dict_from_jax(
        {kind: {'backbone': tree}} if kind == 'params' else
        {'params': {'backbone': {}}, kind: tree})
    return {k[len('backbone.'):]: v.numpy() for k, v in state.items()}


def _loss_scale(metrics):
    """The biHomE loss is ln1 + ln2 + mu*ln3, whose terms largely cancel:
    its error is read against the sum of their magnitudes."""
    return sum(abs(float(metrics[f'loss_comp/ln{i}'])) for i in (1, 2, 3))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _metrics_equal(got, one):
    """Every logged metric of the ranks is the one-process value: the loss
    within 2e-4 of its terms' magnitudes, MACE rtol 1e-5, the others
    (sums, minima and means over the batch) rtol 1e-4."""
    assert set(got) == set(one)
    scale = _loss_scale(one)
    assert abs(got['loss/train'] - one['loss/train']) / scale < 2e-4
    np.testing.assert_allclose(got['mace/train'], one['mace/train'],
                               rtol=1e-5)
    for k in one:
        if k not in ('loss/train', 'mace/train'):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_two_rank_loss_equals_one_process_and_jax(steps):
    one = steps['one']['metrics']
    for r in steps['ranks']:
        got = r['metrics']
        _metrics_equal(got, one)
        scale = _loss_scale(one)
        jax_metrics = steps['jax']['metrics']
        assert abs(got['loss/train'] - jax_metrics['loss/train']) \
            / scale < 1e-3
        np.testing.assert_allclose(got['mace/train'],
                                   jax_metrics['mace/train'], rtol=1e-3)


def _grads_equal(ranks, one):
    for r in ranks:
        got = r['grads']
        assert set(got) == set(one)
        names = [n for n in one if n != 'layer8.0.bias']  # 0 analytically
        flat = np.concatenate([got[n].ravel() for n in names])
        flat_one = np.concatenate([one[n].ravel() for n in names])
        assert _rel_l2(flat, flat_one) < 1e-4
        for n in names:
            assert _rel_l2(got[n], one[n]) < 2e-3, n
    for n in one:
        np.testing.assert_array_equal(ranks[0]['grads'][n],
                                      ranks[1]['grads'][n])


def test_two_rank_gradients_equal_one_process(steps):
    _grads_equal(steps['ranks'], steps['one']['grads'])


def test_two_rank_drawn_step_equals_one_process(steps):
    # The step's own draws (corners, deltas, both copies' distortion, the
    # DSAC uniforms of both fields), made for the global batch and sliced
    # on each rank, against the one-process step's.
    one = steps['one_drawn']
    for r in steps['ranks_drawn']:
        _metrics_equal(r['metrics'], one['metrics'])
    _grads_equal(steps['ranks_drawn'], one['grads'])
    for r in steps['ranks_drawn']:
        for name, want in one['stats'].items():
            np.testing.assert_allclose(r['stats'][name], want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_two_rank_gradients_match_jax(steps):
    want = _from_jax(steps['jax']['grads'], 'params')
    got = steps['ranks'][0]['grads']
    assert set(want) == set(got)
    rel_max = []
    for name, w in want.items():
        if name == 'layer8.0.bias':
            assert np.abs(got[name]).max() < 1e-3
            continue
        assert _rel_l2(got[name], w) < 3e-2, name
        rel_max.append(float(np.abs(got[name] - w).max() / np.abs(w).max()))
    assert np.median(rel_max) < 1e-2


def test_two_rank_parameters_after_adam(steps):
    want = _from_jax(steps['jax']['params'], 'params')
    for r in steps['ranks']:
        for name, w in want.items():
            np.testing.assert_allclose(r['params'][name], w, atol=2.5e-3,
                                       err_msg=name)
            np.testing.assert_allclose(r['params'][name],
                                       steps['one']['params'][name],
                                       atol=2.5e-3, err_msg=name)


def test_two_rank_running_statistics(steps):
    want = _from_jax(steps['jax']['stats'], 'batch_stats')
    r0, r1 = (r['stats'] for r in steps['ranks'])
    for name, w in want.items():
        np.testing.assert_array_equal(r0[name], r1[name])
        np.testing.assert_allclose(r0[name], steps['one']['stats'][name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(r0[name], w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.fixture(scope='module')
def pool_draws():
    return h.run_ranks(h.pool_draw_worker, 2, 9, 4, 21)


def test_pool_without_shard_slices_the_global_draw(pool_draws):
    want = torch.randint(0, 9, (4,),
                         generator=torch.Generator().manual_seed(21))
    np.testing.assert_array_equal(
        np.concatenate([r['whole'] for r in pool_draws]), want.numpy())


def test_pool_shard_rows_and_per_rank_draws(pool_draws):
    from bihome_torch.data import pipeline
    # P = 9 rounded down to 8: rows [0, 4) and [4, 8).
    assert [r['rows'] for r in pool_draws] == [(0, 4), (4, 8)]
    for rank, r in enumerate(pool_draws):
        lo, hi = r['rows']
        idx = torch.randint(0, hi - lo, (2,), generator=torch.Generator()
                            .manual_seed(pipeline.sample_seed(21, rank)))
        np.testing.assert_array_equal(r['sharded'], lo + idx.numpy())


def test_batch_the_ranks_do_not_divide_raises(pool_draws):
    from bihome_torch.parallel import mesh
    for r in pool_draws:
        assert r['error'] == 'batch 5 % ranks 2 != 0'
    with pytest.raises(ValueError):
        mesh.shard_range(5, 2, 0)


@pytest.mark.parametrize('sampling', ['reference-weighted', 'uniform'])
def test_dsac_draws_of_rows_make_up_the_global_draw(sampling):
    from bihome_torch.heads import dsac

    def draw(shape, rows=None):
        return dsac.sample_point_indices(
            shape, 50, sampling, generator=torch.Generator().manual_seed(3),
            rows=rows)
    want = draw((4, 6))
    got = torch.cat([draw((2, 6), (lo, 4)) for lo in (0, 2)])
    assert torch.equal(got, want)


def test_pair_draws_of_rows_make_up_the_global_batch():
    from bihome_torch.data import pipeline
    spec = pipeline.PairSpec(rho=8, patch_size=32,
                             photometric_full_keys=('patch_1', 'patch_2'))
    images = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (4, 64, 64, 3)).astype(np.uint8))

    def pairs(lo, b, rows):
        return pipeline.generate_pairs(
            images[lo:lo + b], spec, torch.Generator().manual_seed(5),
            rows=rows)
    want = pairs(0, 4, None)
    halves = [pairs(lo, 2, (lo, 4)) for lo in (0, 2)]
    assert set(halves[0]) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(
            torch.cat([h[key] for h in halves]), value, rtol=0, atol=0,
            msg=key)
    blob = dataclasses.replace(spec, blob_porosity=0.5)
    with pytest.raises(NotImplementedError):
        pipeline.generate_pairs(images[:2], blob, rows=(0, 4))
