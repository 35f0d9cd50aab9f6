"""Port warp (bihome_torch.ops.warp) against the JAX reference: the TPU
kernel ``warp_pallas.tent_sample_batched`` in Pallas interpret mode, and
``jax.vmap(geometry.bilinear_sample)``.

On the CPU the wrappers take the plain paths, so the launch counters stay
0. Tolerance: 1e-3 absolute on 0..255 pixel values (float32 on both sides;
the tent contraction and the 4-tap gather sum in different orders); the
gradients within 1e-4 of their largest entry. The backward
(``ops/warp.BilinearSample``: du/dv and the image gradient) is held
against the VJP of the Pallas kernels (``_bwd_uv_kernel``,
``_bwd_img_kernel``) and, off integer coordinates, against autodiff of the
gather; at exact integers it follows the Pallas convention (0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import geometry as jgeo
from bihome_tpu.ops import warp_pallas
from bihome_torch.ops import warp


def _inputs(channels, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.uniform(0, 255, (2, 24, 30, channels)).astype(np.float32)
    # Off the integer grid; about a tenth of the points fall outside.
    u = rs.uniform(-3, 33, (2, 700)).astype(np.float32)
    v = rs.uniform(-3, 27, (2, 700)).astype(np.float32)
    return imgs, u, v


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_plain_warp_matches_pallas_kernel_and_gather(channels):
    # Every C the card's kernels specialise (1-4; C = 2 is the masked loss
    # warp, C = 3 image_2 and the RGB window warp).
    imgs, u, v = _inputs(channels)
    before = warp.bilinear_sample_batched.launches
    got = warp.bilinear_sample_batched(torch.from_numpy(imgs),
                                       torch.from_numpy(u),
                                       torch.from_numpy(v)).numpy()
    assert warp.bilinear_sample_batched.launches == before == 0
    assert got.shape == (2, 700, channels)
    pallas = warp_pallas.tent_sample_batched(
        jnp.asarray(imgs), jnp.asarray(u), jnp.asarray(v))
    gather = jax.vmap(jgeo.bilinear_sample)(
        jnp.asarray(imgs), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(gather), rtol=1e-5, atol=1e-3)


def test_far_outside_points_are_zero():
    imgs, _, _ = _inputs(1, seed=1)
    u = np.array([[-1e9, 1e9, -1.5, 30.5, np.float32(3e38)] * 2] * 2,
                 np.float32)
    v = np.full_like(u, 5.25)
    got = warp.bilinear_sample_plain(torch.from_numpy(imgs),
                                     torch.from_numpy(u), torch.from_numpy(v))
    assert torch.all(got == 0)


def _vjp_inputs(channels, seed):
    imgs, u, v = _inputs(channels, seed)
    rs = np.random.RandomState(seed + 100)
    g = rs.randn(2, 700, channels).astype(np.float32)
    return imgs, u, v, g


def _port_grads(imgs, u, v, g):
    ti, tu, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (imgs, u, v))
    out = warp.BilinearSample.apply(ti, tu, tv)
    (out * torch.from_numpy(g)).sum().backward()
    return ti.grad.numpy(), tu.grad.numpy(), tv.grad.numpy()


def _jax_grads(fn, imgs, u, v, g):
    def loss(i, a, b):
        return jnp.sum(fn(i, a, b) * g)
    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(imgs), jnp.asarray(u), jnp.asarray(v))]


def _assert_scaled(got, want, name):
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize('channels', [1, 3])
def test_warp_backward_matches_pallas_vjp_and_gather(channels):
    imgs, u, v, g = _vjp_inputs(channels, seed=channels)
    assert ((u < 0) | (u > 29) | (v < 0) | (v > 23)).mean() > 0.05
    got = _port_grads(imgs, u, v, g)
    assert warp.bilinear_sample_bwd_uv.launches == 0
    assert warp.bilinear_sample_bwd_img.launches == 0
    pallas = _jax_grads(warp_pallas.tent_sample_batched, imgs, u, v, g)
    gather = _jax_grads(jax.vmap(jgeo.bilinear_sample), imgs, u, v, g)
    for name, a, b, c in zip(('dimg', 'du', 'dv'), got, pallas, gather):
        assert a.shape == b.shape
        _assert_scaled(a, b, f'{name} vs Pallas')
        _assert_scaled(a, c, f'{name} vs gather')


def test_warp_backward_is_zero_at_integer_coordinates_like_pallas():
    imgs, u, v, g = _vjp_inputs(1, seed=5)
    # Half the points on exact integers in u, a quarter in v as well.
    u[:, ::2] = np.round(u[:, ::2])
    v[:, ::4] = np.round(v[:, ::4])
    got = _port_grads(imgs, u, v, g)
    pallas = _jax_grads(warp_pallas.tent_sample_batched, imgs, u, v, g)
    for name, a, b in zip(('dimg', 'du', 'dv'), got, pallas):
        _assert_scaled(a, b, name)
    _, du, dv = got
    assert np.all(du[:, ::2] == 0) and np.all(dv[:, ::4] == 0)
    assert np.abs(du[:, 1::2]).max() > 0
    # The gather's autodiff is one-sided there instead: not zero.
    gather = _jax_grads(jax.vmap(jgeo.bilinear_sample), imgs, u, v, g)
    assert np.abs(gather[1][:, ::2]).max() > 0
