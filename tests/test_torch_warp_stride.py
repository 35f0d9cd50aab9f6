"""The warp (K3's plain path on the CPU) and its image gradient (K5's) on
the upsample grid broadcast over the batch, against the JAX package's
``warp_pallas.tent_sample_batched`` (its Pallas kernels in interpret mode,
and their VJP) and against the same grid materialised.

``heads/assembled.upsample_grid`` returns one row of points ``expand``ed
over the batch (strides (0, 1)); ``ops/warp.BilinearSample`` hands it to
``bilinear_sample_batched`` and, saved so, to ``bilinear_sample_bwd_img``
as it is (on the card both kernels read the one row, batch stride 0).
Tolerance: the upsampled image within 1e-5 and the image gradient within
1e-4 of their largest entry against JAX (float32 on both sides: the
Pallas kernel contracts tent weights where the port gathers 4 taps, and
the gradient sums in another order), and both bit for bit against the
materialised grid (the same plain arithmetic on the same values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.ops import warp_pallas
from bihome_torch.heads.assembled import upsample_align_corners, upsample_grid
from bihome_torch.ops import warp


def _image_grad(images, u, v, g):
    img = torch.from_numpy(images).requires_grad_(True)
    out = warp.BilinearSample.apply(img, u, v)
    (out * torch.from_numpy(g)).sum().backward()
    return img.grad.numpy()


@pytest.mark.parametrize('scale', [2, 4])
def test_broadcast_upsample_grid_image_grad_matches_pallas_vjp(
        scale, monkeypatch):
    rs = np.random.RandomState(scale)
    n, h, w, c = 2, 8, 8, 1
    images = rs.randn(n, h, w, c).astype(np.float32)
    u, v = upsample_grid(n, h, w, scale, torch.device('cpu'))
    assert u.stride() == (0, 1) and v.stride() == (0, 1)
    p = u.shape[1]
    g = rs.randn(n, p, c).astype(np.float32)

    seen = []
    real = warp.bilinear_sample_bwd_img

    def spy(uu, vv, gg, shape):
        seen.append((uu.stride(), vv.stride()))
        return real(uu, vv, gg, shape)
    monkeypatch.setattr(warp, 'bilinear_sample_bwd_img', spy)
    got = _image_grad(images, u, v, g)
    assert seen == [((0, 1), (0, 1))]
    materialised = _image_grad(images, u.contiguous(), v.contiguous(), g)
    assert seen[1] == ((p, 1), (p, 1))
    np.testing.assert_array_equal(got, materialised)

    un, vn = u.numpy(), v.numpy()
    _, vjp = jax.vjp(lambda x: warp_pallas.tent_sample_batched(
        x, jnp.asarray(un), jnp.asarray(vn)), jnp.asarray(images))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    scale_ = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale_, want / scale_, rtol=0, atol=1e-4)
    assert real.launches == 0


@pytest.mark.parametrize('scale', [2, 4])
def test_upsample_hands_k3_the_broadcast_grid(scale, monkeypatch):
    rs = np.random.RandomState(10 + scale)
    n, h, w, c = 2, 8, 8, 1
    images = rs.randn(n, h, w, c).astype(np.float32)
    seen = []
    real = warp.bilinear_sample_batched

    def spy(img, uu, vv):
        seen.append((uu.stride(), vv.stride()))
        return real(img, uu, vv)
    monkeypatch.setattr(warp, 'bilinear_sample_batched', spy)
    got = upsample_align_corners(torch.from_numpy(images), scale)
    assert seen == [((0, 1), (0, 1))]
    assert got.shape == (n, h * scale, w * scale, c)

    u, v = upsample_grid(n, h, w, scale, torch.device('cpu'))
    materialised = real(torch.from_numpy(images), u.contiguous(),
                        v.contiguous())
    np.testing.assert_array_equal(got.reshape(materialised.shape).numpy(),
                                  materialised.numpy())
    want = np.asarray(warp_pallas.tent_sample_batched(
        jnp.asarray(images), jnp.asarray(u.numpy()), jnp.asarray(v.numpy())))
    scale_ = float(np.abs(want).max())
    np.testing.assert_allclose(got.reshape(want.shape).numpy() / scale_,
                               want / scale_, rtol=0, atol=1e-5)
    assert real.launches == 0 and real.generic_launches == 0
