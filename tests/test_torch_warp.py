"""Port warp (bihome_torch.ops.warp) against the JAX reference: the TPU
kernel ``warp_pallas.tent_sample_batched`` in Pallas interpret mode, and
``jax.vmap(geometry.bilinear_sample)``.

On the CPU the wrapper takes the plain path, so its launch counter stays 0.
Tolerance: 1e-3 absolute on 0..255 pixel values (float32 on both sides;
the tent contraction and the 4-tap gather sum in different orders).
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


@pytest.mark.parametrize('channels', [1, 3])
def test_plain_warp_matches_pallas_kernel_and_gather(channels):
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
