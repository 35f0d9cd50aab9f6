"""Port geometry (bihome_torch.geometry) against the JAX reference
(bihome_tpu.geometry), function by function, on the CPU.

Inputs come from a seeded numpy RandomState and go to both packages.
Tolerances: float32 on both sides with the same formulas, so 1e-4
relative / 1e-3 px absolute unless a case states otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import geometry as jgeo
from bihome_torch import geometry as tgeo

RTOL, ATOL = 1e-4, 1e-3


def _corners_deltas(rs, batch=4, rho=8, patch=32, img_w=64, img_h=64):
    px = rs.randint(rho + patch // 2, img_w - rho - patch // 2 + 1, batch)
    py = rs.randint(rho + patch // 2, img_h - rho - patch // 2 + 1, batch)
    half = patch // 2
    corners = np.stack([np.stack([px - half, py - half], -1),
                        np.stack([px + half, py - half], -1),
                        np.stack([px + half, py + half], -1),
                        np.stack([px - half, py + half], -1)], 1)
    deltas = rs.randint(-rho, rho, (batch, 4, 2))
    return corners.astype(np.float32), deltas.astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _homographies(rs, batch=4):
    corners, deltas = _corners_deltas(rs, batch)
    return np.asarray(jgeo.four_point_to_homography(jnp.asarray(corners),
                                                    jnp.asarray(deltas)))


@pytest.mark.parametrize('batch_size', [None, 3])
def test_image_corners(batch_size):
    _close(tgeo.image_corners(24, 32, batch_size=batch_size),
           jgeo.image_corners(24, 32, batch_size=batch_size), 0, 0)


def test_normalization_transforms():
    pts = np.random.RandomState(0).uniform(-50, 300, (3, 6, 2)).astype(
        np.float32)
    t_j, n_j = jgeo._normalization_transform(jnp.asarray(pts))
    t_t, n_t = tgeo._normalization_transform(_t(pts))
    _close(t_t, t_j, atol=1e-6)
    _close(n_t, n_j, atol=1e-6)
    _close(tgeo._denormalization_transform(_t(pts)),
           jgeo._denormalization_transform(jnp.asarray(pts)))


def test_inv3x3():
    m = (np.random.RandomState(1).randn(5, 3, 3)
         + 3 * np.eye(3)).astype(np.float32)
    _close(tgeo.inv3x3(_t(m)), jgeo.inv3x3(jnp.asarray(m)), atol=1e-5)


def test_square_to_quad():
    corners, deltas = _corners_deltas(np.random.RandomState(2))
    quad = (corners + deltas) / 64.0
    _close(tgeo._square_to_quad(_t(quad)), jgeo._square_to_quad(
        jnp.asarray(quad)), atol=1e-5)


@pytest.mark.parametrize('crop', [False, True])
def test_four_point_to_homography(crop):
    corners, deltas = _corners_deltas(np.random.RandomState(3))
    got = tgeo.four_point_to_homography(_t(corners), _t(deltas), crop=crop)
    want = jgeo.four_point_to_homography(jnp.asarray(corners),
                                         jnp.asarray(deltas), crop=crop)
    _close(got, want, atol=1e-5)
    _close(tgeo.get_perspective_transform(_t(corners), _t(corners + deltas)),
           jgeo.get_perspective_transform(jnp.asarray(corners),
                                          jnp.asarray(corners + deltas)),
           atol=1e-5)


def test_normalize_gauge_h33_crossing_zero():
    # The datagen draw whose true h33 passes through ~0 (regression case of
    # tests/test_geometry.py): dividing by h33 gives inf/NaN in float32.
    corners = np.array([[[44., 58.], [172., 58.], [172., 186.],
                         [44., 186.]]], np.float32)
    delta = np.array([[[-23., -5.], [18., 20.], [-9., -31.], [25., 5.]]],
                     np.float32)
    got = tgeo.four_point_to_homography(_t(corners), _t(delta))
    assert torch.isfinite(got).all()
    want = jgeo.four_point_to_homography(jnp.asarray(corners),
                                         jnp.asarray(delta))
    _close(got, want, atol=1e-5)
    _close(tgeo.transform_points(got, _t(corners)), corners + delta,
           atol=0.1)
    h_raw = np.array([[[2.0, 0.1, 5.0], [0.2, 1.5, 7.0], [1e-3, 2e-3,
                                                          1e-9]]], np.float32)
    _close(tgeo._normalize_gauge(_t(h_raw)),
           jgeo._normalize_gauge(jnp.asarray(h_raw)), atol=1e-6)


def test_transform_points():
    rs = np.random.RandomState(4)
    h = _homographies(rs)
    pts = rs.uniform(0, 64, (4, 20, 2)).astype(np.float32)
    _close(tgeo.transform_points(_t(h), _t(pts)),
           jgeo.transform_points(jnp.asarray(h), jnp.asarray(pts)))


@pytest.mark.parametrize('channels', [1, 3])
def test_bilinear_sample(channels):
    rs = np.random.RandomState(5)
    img = rs.uniform(0, 255, (20, 24, channels)).astype(np.float32)
    # Off the integer grid, with some points outside the image.
    x = rs.uniform(-3, 27, 300).astype(np.float32)
    y = rs.uniform(-3, 23, 300).astype(np.float32)
    _close(tgeo.bilinear_sample(_t(img), _t(x), _t(y)),
           jgeo.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                jnp.asarray(y)))


def test_crop_integer():
    rs = np.random.RandomState(6)
    imgs = rs.uniform(0, 255, (3, 40, 50, 2)).astype(np.float32)
    x0 = rs.randint(0, 50 - 16, 3)
    y0 = rs.randint(0, 40 - 12, 3)
    _close(tgeo.crop_integer(_t(imgs), _t(x0), _t(y0), (12, 16)),
           jgeo.crop_integer(jnp.asarray(imgs), jnp.asarray(x0),
                             jnp.asarray(y0), (12, 16)), 0, 0)
    same = tgeo.crop_integer(_t(imgs), _t(x0 * 0), _t(y0 * 0), (40, 50))
    _close(same, imgs, 0, 0)


@pytest.mark.parametrize('with_offset', [False, True])
def test_homography_grid(with_offset):
    rs = np.random.RandomState(7)
    h = _homographies(rs, 3)
    offset = rs.randint(0, 20, (3, 2)).astype(np.float32) if with_offset \
        else None
    u_t, v_t = tgeo.homography_grid(
        _t(h), (12, 16), None if offset is None else _t(offset))
    u_j, v_j = jgeo.homography_grid(
        jnp.asarray(h), (12, 16), None if offset is None
        else jnp.asarray(offset))
    _close(u_t, u_j)
    _close(v_t, v_j)


def test_normalize_point_cloud():
    pts = np.random.RandomState(8).uniform(0, 128, (4, 128, 2)).astype(
        np.float32)
    n_t, t_t = tgeo._normalize_point_cloud(_t(pts))
    n_j, t_j = jgeo._normalize_point_cloud(jnp.asarray(pts))
    _close(n_t, n_j, atol=1e-5)
    _close(t_t, t_j, atol=1e-5)


def test_solve_psd_unrolled():
    rs = np.random.RandomState(9)
    a = rs.randn(4, 8, 16).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(8, dtype=np.float32)
    b = rs.randn(4, 8).astype(np.float32)
    got = tgeo.solve_psd_unrolled(_t(spd), _t(b))
    _close(got, jgeo.solve_psd_unrolled(jnp.asarray(spd), jnp.asarray(b)))
    _close(got, np.linalg.solve(spd.astype(np.float64), b[..., None])[..., 0],
           atol=1e-3)


@pytest.mark.parametrize('weighted', [False, True])
def test_find_homography_dlt_128_points(weighted):
    # The DSAC fit: 128 points of a perspective field with pixel noise.
    rs = np.random.RandomState(10)
    h = _homographies(rs, 4)
    p1 = rs.uniform(0, 32, (4, 128, 2)).astype(np.float32)
    p2 = np.asarray(jgeo.transform_points(jnp.asarray(h), jnp.asarray(p1)))
    p2 = (p2 + rs.normal(0, 0.5, p2.shape)).astype(np.float32)
    w = rs.uniform(0.1, 1, (4, 128)).astype(np.float32) if weighted else None
    got = tgeo.find_homography_dlt(_t(p1), _t(p2),
                                   None if w is None else _t(w))
    want = jgeo.find_homography_dlt(jnp.asarray(p1), jnp.asarray(p2),
                                    None if w is None else jnp.asarray(w))
    _close(got, want, rtol=1e-3, atol=1e-4)
    # Compared where it matters: the mapped patch corners, in px.
    fp = np.tile(np.array([[0, 0], [32, 0], [32, 32], [0, 32]],
                          np.float32), (4, 1, 1))
    _close(tgeo.transform_points(got, _t(fp)),
           jgeo.transform_points(want, jnp.asarray(fp)), atol=1e-3)


def test_mace():
    rs = np.random.RandomState(11)
    a = rs.uniform(-8, 8, (5, 4, 2)).astype(np.float32)
    b = rs.uniform(-8, 8, (5, 4, 2)).astype(np.float32)
    _close(tgeo.mace(_t(a), _t(b)), jgeo.mace(jnp.asarray(a),
                                              jnp.asarray(b)), atol=1e-5)


def test_ones_warp_mask_and_its_gradient():
    rs = np.random.RandomState(7)
    u = rs.uniform(-3, 35, (2, 400)).astype(np.float32)
    v = rs.uniform(-3, 27, (2, 400)).astype(np.float32)
    g = rs.randn(2, 400).astype(np.float32)
    import jax
    want = jgeo.ones_warp_mask(jnp.asarray(u), jnp.asarray(v), (24, 32))
    want_du, want_dv = jax.grad(
        lambda a, b: jnp.sum(jgeo.ones_warp_mask(a, b, (24, 32)) * g),
        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    tu, tv = _t(u).requires_grad_(True), _t(v).requires_grad_(True)
    got = tgeo.ones_warp_mask(tu, tv, (24, 32))
    (got * _t(g)).sum().backward()
    _close(got.detach(), want, 0, 1e-6)
    assert 0 < float(got.detach().mean()) < 1
    _close(tu.grad, want_du, 0, 1e-6)
    _close(tv.grad, want_dv, 0, 1e-6)


def test_warp_chain_gradients_match_jax():
    """Gradient of a scalar of the loss-warp chain with respect to the
    corner offsets: four_point_to_homography -> homography_grid ->
    ones_warp_mask, and transform_points, against jax.grad (1e-4
    relative to the largest entry; no in-place op breaks autograd)."""
    import jax
    rs = np.random.RandomState(8)
    corners = np.broadcast_to(np.array([[0, 0], [32, 0], [32, 32], [0, 32]],
                                       np.float32), (3, 4, 2)).copy()
    deltas = rs.uniform(-6, 6, (3, 4, 2)).astype(np.float32)
    pts = rs.uniform(0, 32, (3, 9, 2)).astype(np.float32)

    def chain(geo, c, d, p):
        hom = geo.four_point_to_homography(c, d)
        u, v = geo.homography_grid(hom, (32, 32))
        mask = geo.ones_warp_mask(u, v, (32, 32))
        return (mask * (u + 0.5 * v)).sum() + (geo.transform_points(
            hom, p) ** 2).sum()

    want = jax.grad(lambda d: chain(jgeo, jnp.asarray(corners),
                                    d, jnp.asarray(pts)))(jnp.asarray(deltas))
    td = _t(deltas).requires_grad_(True)
    chain(tgeo, _t(corners), td, _t(pts)).backward()
    scale = float(np.abs(np.asarray(want)).max())
    _close(td.grad / scale, np.asarray(want) / scale, 0, 1e-4)


def test_dlt_gradients_match_jax():
    """find_homography_dlt's gradient with respect to the target points
    (the path DSAC sends the loss into the perspective field), 128 points:
    1e-3 relative to the largest entry (the normal equations' solve)."""
    import jax
    rs = np.random.RandomState(9)
    p1 = rs.uniform(0, 32, (2, 128, 2)).astype(np.float32)
    p2 = (p1 + rs.randn(2, 128, 2) * 2).astype(np.float32)
    w = rs.randn(2, 3, 3).astype(np.float32)
    want = jax.grad(lambda b: jnp.sum(jgeo.find_homography_dlt(
        jnp.asarray(p1), b) * w))(jnp.asarray(p2))
    tp2 = _t(p2).requires_grad_(True)
    (tgeo.find_homography_dlt(_t(p1), tp2) * _t(w)).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    _close(tp2.grad / scale, np.asarray(want) / scale, 0, 1e-3)
