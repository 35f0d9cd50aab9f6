"""The pure parts of the port's pretext training
(``bihome_torch/pretrain/targets.py``) against ``tools/pretrain_aux.py``'s
on numpy-seeded inputs, float32.

* The six fixed projections in ``bihome_torch/pretrain/projections.npz``
  equal the installed JAX's ``jax.random.normal(PRNGKey(42|43), (k, d)) /
  jnp.sqrt(float(k))`` bit for bit (:func:`jax_projections` is how the
  file was made; Threefry's partitionable default changed between JAX
  releases, so this test, not the file, is the truth).
* ``grad_targets`` (rich or not, stride 4 / 64 and 8 / 128),
  ``grad_targets_pi``, ``nnavg_pool``, the edge-replicated 3x3 filter
  and the blur, ``dense_infonce`` (rex 0 and 2, hard_beta 0 and 0.5,
  invalid anchors and candidates), ``basin_ratio``, ``warp_gt``: within
  rtol 1e-5 and an absolute 1e-6 of the largest value (``_close``); the
  InfoNCE accuracy exactly; ``warp_gt``'s image within 1e-4 of its
  largest value (the warp sums its taps in another order).
* ``grad_targets_pi`` is invariant to brightness offsets (edge padding)
  and, up to its epsilon, to contrast, as JAX's is
  (``tests/test_pretext.py:134``).
* The RotNet rotation: the port's per-sample rotation equals JAX's flip
  and transpose composition (``:303-309``) and ``np.rot90`` on the same
  rotation ints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_torch import pretrain_aux
from bihome_torch.pretrain import targets


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while this file runs: its CPU work is
    small, and the parallel test run's workers then do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


tools = pytest.importorskip('tools.pretrain_aux')

SHAPES = (('grad', 42, 12), ('grad', 42, 24), ('gradpi', 43, 8))


def jax_projections():
    """The six projections as ``projections.npz`` holds them."""
    out = {}
    for name, seed, k in SHAPES:
        for d in (64, 128):
            out[f'{name}_{k}x{d}'] = np.asarray(
                jax.random.normal(jax.random.PRNGKey(seed), (k, d))
                / jnp.sqrt(float(k)))
    return out


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def _patches(b=2, side=64, seed=0):
    """Smooth structure plus noise, so that every scale has gradients."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:side, 0:side] / float(side)
    base = np.sin(6 * xx + 4 * yy)[None, ..., None]
    return (base + 0.2 * rs.rand(b, side, side, 1)).astype(np.float32)


@pytest.mark.parametrize('key', [f'{n}_{k}x{d}' for n, _, k in SHAPES
                                 for d in (64, 128)])
def test_projection_is_jax_draw_bit_for_bit(key):
    want = jax_projections()[key]
    name, shape = key.rsplit('_', 1)
    got = targets.projection(name, *map(int, shape.split('x')))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    made = str(np.load(targets._PROJECTIONS)['jax_version'])
    print(f'{key}: the file was made with JAX {made}, installed '
          f'{jax.__version__}')


@pytest.mark.parametrize('rich', [False, True], ids=['plain', 'rich'])
@pytest.mark.parametrize('stride,out_dim', [(4, 64), (8, 128)])
def test_grad_targets_match_jax(rich, stride, out_dim):
    x = _patches()
    want = tools.grad_targets(jnp.asarray(x), rich=rich, stride=stride,
                              out_dim=out_dim)
    got = targets.grad_targets(torch.from_numpy(x), rich, stride, out_dim)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize('stride,out_dim', [(4, 64), (8, 128)])
def test_grad_targets_pi_match_jax(stride, out_dim):
    x = _patches(seed=1)
    want = tools.grad_targets_pi(jnp.asarray(x), stride=stride,
                                 out_dim=out_dim)
    got = targets.grad_targets_pi(torch.from_numpy(x), stride, out_dim)
    # The per-sample normalisation divides by a mean of 8 * 16^2 values:
    # its summation order moves the last bits, tanh then keeps them.
    _close(got, want, rtol=1e-5)


def test_filters_and_pool_match_jax():
    x = np.random.RandomState(2).randn(2, 12, 16, 3).astype(np.float32)
    k = np.random.RandomState(3).randn(3, 3).astype(np.float32)
    kt = torch.from_numpy(k)
    want = tools._sobel(jnp.asarray(x), jnp.asarray(k))
    _close(targets.conv3_edge(torch.from_numpy(x), kt), want)
    _close(targets.blur(torch.from_numpy(x), 5),
           tools._blur(jnp.asarray(x), 5))
    _close(targets.nnavg_pool(torch.from_numpy(x), 4),
           tools.nnavg_pool(jnp.asarray(x), 4))
    # Edge replication: a constant image gives sum(k) times it everywhere.
    c = torch.full((1, 5, 5, 1), 2.5)
    torch.testing.assert_close(targets.conv3_edge(c, kt),
                               torch.full_like(c, 2.5 * float(k.sum())))


def test_grad_targets_pi_brightness_invariance():
    """As JAX's ``test_gradpi_invariant_to_brightness_contrast``: offsets
    cancel (edge-replicated padding), contrast leaves the epsilon's
    residual; the plain targets are not invariant."""
    x = torch.from_numpy(_patches(side=128))
    t0 = targets.grad_targets_pi(x)
    torch.testing.assert_close(targets.grad_targets_pi(x + 0.4), t0,
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(targets.grad_targets_pi(1.3 * (x + 0.4)), t0,
                               rtol=0, atol=2e-3)
    g0, g1 = targets.grad_targets(x), targets.grad_targets(1.3 * (x + 0.4))
    assert float((g0 - g1).abs().max()) > 1e-2


def _infonce_inputs(seed=3):
    rs = np.random.RandomState(seed)
    f1 = rs.randn(2, 8, 8, 16).astype(np.float32)
    f2 = (f1 + 0.6 * rs.randn(2, 8, 8, 16)).astype(np.float32)
    valid = np.ones((2, 8, 8), np.float32)
    valid[0, :2] = 0.5                      # invalid anchors and candidates
    valid[1, :, -1] = 0.0
    return f1, f2, valid


@pytest.mark.parametrize('hard_beta', [0.0, 0.5])
@pytest.mark.parametrize('rex', [0, 2])
def test_dense_infonce_matches_jax(rex, hard_beta):
    f1, f2, valid = _infonce_inputs()
    want = tools.dense_infonce(jnp.asarray(f1), jnp.asarray(f2),
                               jnp.asarray(valid), tau=0.15, rex=rex,
                               hard_beta=hard_beta)
    ft1, ft2 = (torch.from_numpy(f).requires_grad_(True) for f in (f1, f2))
    got = targets.dense_infonce(ft1, ft2, torch.from_numpy(valid), 0.15,
                                rex, hard_beta)
    _close(got[0].detach(), want[0])
    assert float(got[1]) == float(want[1])

    def jloss(a, b):
        return tools.dense_infonce(a, b, jnp.asarray(valid), tau=0.15,
                                   rex=rex, hard_beta=hard_beta)[0]
    ja, jb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    got[0].backward()
    _close(ft1.grad, ja, rtol=1e-4)
    _close(ft2.grad, jb, rtol=1e-4)


def test_dense_infonce_takes_the_first_maximum():
    """Equal candidates (a tie in every row): both sides take the first,
    which is the positive for anchor 0 only (1/4 over 4 anchors, less the
    1e-6 in the denominator)."""
    f = np.ones((1, 2, 2, 4), np.float32)
    valid = np.ones((1, 2, 2), np.float32)
    want = tools.dense_infonce(jnp.asarray(f), jnp.asarray(f),
                               jnp.asarray(valid), rex=0)
    got = targets.dense_infonce(torch.from_numpy(f), torch.from_numpy(f),
                                torch.from_numpy(valid), rex=0)
    assert float(got[1]) == float(want[1])
    assert abs(float(got[1]) - 0.25) < 1e-6


def test_basin_ratio_matches_jax():
    rs = np.random.RandomState(4)
    f2 = rs.randn(2, 8, 8, 4).astype(np.float32)
    near = (f2 + 0.05 * rs.randn(2, 8, 8, 4)).astype(np.float32)
    far = (f2 + 0.3 * rs.randn(2, 8, 8, 4)).astype(np.float32)
    v = np.ones((2, 8, 8), np.float32)
    ve = v.copy()
    ve[:, :3] = 0.9
    want = tools.basin_ratio(*map(jnp.asarray, (near, far, f2, v, ve)))
    got = targets.basin_ratio(*map(torch.from_numpy, (near, far, f2, v, ve)))
    _close(got, want)


def test_warp_gt_matches_jax():
    x = _patches(b=3, side=48, seed=5)
    delta = np.random.RandomState(6).uniform(-6, 6, (3, 4, 2)).astype(
        np.float32)
    want_img, want_mask = tools.warp_gt(jnp.asarray(x), jnp.asarray(delta))
    got_img, got_mask = targets.warp_gt(torch.from_numpy(x),
                                        torch.from_numpy(delta))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=1e-4 * np.abs(x).max())
    np.testing.assert_allclose(got_mask.numpy(), np.asarray(want_mask),
                               rtol=0, atol=1e-4)


def test_rotation_matches_jax_and_rot90():
    x = np.random.RandomState(7).randn(8, 6, 6, 1).astype(np.float32)
    rot = np.array([0, 1, 2, 3, 3, 2, 1, 0])
    xj = jnp.asarray(x)
    x90 = jnp.transpose(xj[:, :, ::-1], (0, 2, 1, 3))
    x180 = xj[:, ::-1, ::-1]
    x270 = jnp.transpose(xj, (0, 2, 1, 3))[:, :, ::-1]
    stacked = jnp.stack([xj, x90, x180, x270], axis=1)
    want = np.asarray(jnp.take_along_axis(
        stacked, jnp.asarray(rot)[:, None, None, None, None], axis=1)[:, 0])
    got = pretrain_aux.rotate(torch.from_numpy(x),
                              torch.from_numpy(rot)).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(8):
        np.testing.assert_array_equal(got[b], np.rot90(x[b], rot[b]))
