"""The port's RANSAC fit (``bihome_torch.heads.ransac``) against the JAX
package's (``bihome_tpu/heads/ransac.py``), on the same draws.

The JAX functions draw their point indices with
``jax.random.randint(key, (B, 4K), 0, N)`` (``ransac.py:31``); the test
rebuilds those indices from the key and injects them into the port. Where
a case needs draws no key gives (a repeated point in every hypothesis),
``jax.random.randint`` is replaced for the one eager JAX call by a
function that returns them. The JAX inlier counts are those of
``ransac.py:31-44`` computed with the JAX package's own geometry.

Fields are 24x32 (N = 768 points), batch 3, K = 64 hypotheses. Cases: a
clean field of a known homography (every hypothesis ties; the first
wins), 10% gross outliers (30-60 px off), a hypothesis that repeats a
point (its H is NaN and it is masked), a sample whose every hypothesis
repeats a point (no inliers: the all-ones refit), and an explicit tie
between two hypotheses that beat the rest. Tolerances: the winning
hypothesis, its inlier count and the inlier count of every hypothesis
whose pole lies off the field equal exactly; delta and the corner readout
within 1e-3 px; H within 1e-4 of its largest entry.

A hypothesis whose pole lies on the field (its projective denominator
changes sign over the pixels: a degenerate draw, such as an outlier among
its points) maps the points near the pole with unbounded sensitivity, and
float32 rounding of the same formulas (3e-5 of H apart) moves some of them
across the 10 px threshold: on the outlier field 2 of its 192 hypotheses
count 3 and 2 of 768 points apart. Such a hypothesis may count otherwise,
if at most 2% of the hypotheses do and neither count exceeds the winner's;
the winner must be the same, so it cannot change the fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import geometry as jgeo
from bihome_tpu.heads import ransac as jransac
from bihome_torch.heads import ransac as transac

B, H, W, K = 3, 24, 32, 64
N = H * W


def _homographies(rs):
    """[B,3,3] homographies moving the corners by up to 6 px."""
    corners = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float32)
    corners = np.broadcast_to(corners, (B, 4, 2))
    delta = rs.uniform(-6, 6, (B, 4, 2)).astype(np.float32)
    return np.asarray(jgeo.four_point_to_homography(jnp.asarray(corners),
                                                    jnp.asarray(delta)))


def _field(seed, outliers=0.0):
    """PF [B,H,W,2] of known homographies (plus 0.05 px noise), a share
    ``outliers`` of its points moved 30-60 px in a random direction."""
    rs = np.random.RandomState(seed)
    hom = _homographies(rs)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    coords = np.broadcast_to(np.stack([xs.ravel(), ys.ravel()], -1),
                             (B, N, 2)).astype(np.float32)
    mapped = np.asarray(jgeo.transform_points(jnp.asarray(hom),
                                              jnp.asarray(coords)))
    pf = mapped - coords + rs.normal(0, 0.05, (B, N, 2)).astype(np.float32)
    if outliers:
        bad = rs.rand(B, N) < outliers
        angle = rs.uniform(0, 2 * np.pi, (B, N))
        radius = rs.uniform(30, 60, (B, N))
        off = np.stack([np.cos(angle), np.sin(angle)], -1) * radius[..., None]
        pf = pf + np.where(bad[..., None], off, 0).astype(np.float32)
    return pf.reshape(B, H, W, 2).astype(np.float32)


def _points(pf):
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing='ij')
    coords = np.broadcast_to(np.stack([xs.ravel(), ys.ravel()], -1),
                             (B, N, 2)).astype(np.float32)
    return coords, coords + pf.reshape(B, N, 2)


def _jax_counts(points1, points2, idx, threshold=10.0):
    """Inlier counts [B,K], whether each H is finite, and the hypotheses
    [B,K,3,3] of ``ransac.py:31-44`` on the draws ``idx``."""
    p1, p2, idx = jnp.asarray(points1), jnp.asarray(points2), jnp.asarray(idx)
    p1s = jnp.take_along_axis(p1, idx[..., None], axis=1).reshape(B * K, 4, 2)
    p2s = jnp.take_along_axis(p2, idx[..., None], axis=1).reshape(B * K, 4, 2)
    h = jgeo.get_perspective_transform(p1s, p2s)
    q1 = jnp.broadcast_to(p1[:, None], (B, K, N, 2)).reshape(B * K, N, 2)
    q2 = jnp.broadcast_to(p2[:, None], (B, K, N, 2)).reshape(B * K, N, 2)
    err = jnp.linalg.norm(jgeo.transform_points(h, q1) - q2, axis=-1)
    finite = jnp.all(jnp.isfinite(h.reshape(B * K, 9)), -1)
    inliers = (err < threshold) & finite[:, None]
    return (np.asarray(jnp.sum(inliers, -1).reshape(B, K)),
            np.asarray(finite).reshape(B, K),
            np.asarray(h).reshape(B, K, 3, 3))


def _jax_delta(pf, key, idx=None, dtype='float32'):
    """JAX's perspective_field_to_delta(pf, key) on ``pf`` in ``dtype``;
    with ``idx`` its draws replaced by ``idx`` (the call runs eagerly, so
    the patch holds)."""
    if idx is None:
        return tuple(map(np.asarray, jransac.perspective_field_to_delta(
            jnp.asarray(pf).astype(dtype), key)))
    original = jax.random.randint

    def injected(_key, shape, _low, _high):
        assert tuple(shape) == (B, 4 * K)
        return jnp.asarray(idx, jnp.int32)
    jax.random.randint = injected
    try:
        return tuple(map(np.asarray, jransac.perspective_field_to_delta(
            jnp.asarray(pf), key)))
    finally:
        jax.random.randint = original


def _port(pf, idx, dtype='float32'):
    """The port's fit and delta on NHWC ``pf`` (in ``dtype``) given as a
    permuted NCHW view, as the backbone returns it."""
    nchw = torch.from_numpy(np.ascontiguousarray(pf.transpose(0, 3, 1, 2)))
    nchw = nchw.to(getattr(torch, dtype))
    idx = np.array(idx)
    field = nchw.permute(0, 2, 3, 1)
    coords, mapping = transac.field_points(field)
    fit = transac.ransac_fit(coords, mapping, idx=torch.from_numpy(
        np.asarray(idx)))
    delta, hom = transac.perspective_field_to_delta(
        field, idx=torch.from_numpy(np.asarray(idx)))
    assert torch.equal(fit.homography, hom)
    return fit, delta.float().numpy(), hom.float().numpy()


# Pixels a, c, d of the draw [a, c, d, c]: the closed-form solve divides by
# an exact 0 there, and H overflows to NaN in float32 on both sides.
REPEAT = [3 * W + 5, 7 * W + 20, 18 * W + 9, 7 * W + 20]


def _repeat_point(idx, rows):
    """Hypotheses (b, k) in ``rows`` draw REPEAT, a repeated point."""
    idx = np.array(idx).reshape(B, K, 4)
    for b, k in rows:
        idx[b, k] = REPEAT
    return idx.reshape(B, 4 * K)


def _pole_on_field(h, coords):
    """[B,K] whether the denominator h31 x + h32 y + h33 of each finite
    hypothesis H [B,K,3,3] changes sign over the field's points."""
    h = h.astype(np.float64)
    den = (np.einsum('bkj,bnj->bkn', h[:, :, 2, :2], coords.astype(np.float64))
           + h[:, :, 2, 2:3])
    with np.errstate(invalid='ignore'):
        one_sign = np.sign(den).min(-1) == np.sign(den).max(-1)
    return np.isfinite(den).all(-1) & ~one_sign


def _check(pf, key, idx, injected=False, dtype='float32'):
    coords, mapping = _points(pf)
    want_counts, finite, want_hyps = _jax_counts(coords, mapping, idx)
    want_delta, want_h = _jax_delta(pf, key, idx if injected else None,
                                    dtype)
    fit, delta, hom = _port(pf, idx, dtype)
    got_counts = fit.counts.numpy()
    pole = _pole_on_field(want_hyps, coords)
    differ = got_counts != want_counts
    # Counts equal exactly but at a few (at most 2%) hypotheses with their
    # pole on the field, none of which beats the winner.
    assert not (differ & ~pole).any()
    assert differ.sum() <= 0.02 * differ.size
    best = want_counts.max(-1, keepdims=True)
    assert (np.where(differ, np.maximum(got_counts, want_counts), -1)
            <= best).all()
    np.testing.assert_array_equal(fit.best.numpy(),
                                  np.argmax(want_counts, axis=-1))
    np.testing.assert_array_equal(fit.inliers.sum(-1).numpy(),
                                  want_counts.max(-1))
    np.testing.assert_allclose(delta, want_delta, rtol=0, atol=1e-3)
    scale = np.abs(want_h).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(hom / scale, want_h / scale, rtol=0,
                               atol=1e-4)
    return fit, want_counts, finite


def _key_idx(seed):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.randint(key, (B, 4 * K), 0, N))


def test_clean_field_every_hypothesis_ties_and_the_first_wins():
    key, idx = _key_idx(0)
    fit, counts, finite = _check(_field(1), key, idx)
    # Most hypotheses fit every point and tie; a draw that repeats a point
    # in the pattern [a, c, d, c] is NaN, near-collinear draws fit fewer.
    assert (counts.max(-1) == N).all() and (counts == N).mean() > 0.8
    assert (counts[~finite] == 0).all()
    np.testing.assert_array_equal(fit.best.numpy(), np.argmax(counts == N,
                                                              -1))


def test_ten_percent_gross_outliers():
    key, idx = _key_idx(2)
    pf = _field(3, outliers=0.1)
    fit, counts, _ = _check(pf, key, idx)
    # The winner's inliers are the clean points, and some hypotheses
    # (those that drew an outlier) lose.
    assert (counts.max(-1) > 0.85 * N).all() and (counts.min(-1) < N).all()
    ys = (counts == counts.max(-1, keepdims=True))
    assert ys.sum() > B                       # ties among the clean draws
    # The fit read at the corners is that of the clean field.
    clean_delta, _ = _jax_delta(_field(3), key)
    _, delta, _ = _port(pf, idx)
    assert np.abs(delta - clean_delta).max() < 0.1


def test_repeated_point_gives_a_nan_hypothesis_that_is_masked():
    key, idx = _key_idx(4)
    idx = _repeat_point(idx, [(0, 0), (1, 5), (2, 63)])
    pf = _field(5, outliers=0.1)
    fit, counts, finite = _check(pf, key, idx, injected=True)
    for b, k in [(0, 0), (1, 5), (2, 63)]:
        assert not finite[b, k] and counts[b, k] == 0
    assert fit.best.numpy()[0] != 0


def test_no_inliers_falls_back_to_all_ones_weights():
    key, idx = _key_idx(6)
    idx = _repeat_point(idx, [(1, k) for k in range(K)])
    pf = _field(7)
    fit, counts, finite = _check(pf, key, idx, injected=True)
    assert not finite[1].any() and (counts[1] == 0).all()
    assert int(fit.best[1]) == 0 and int(fit.inliers[1].sum()) == 0
    # The all-ones refit of a clean field is its homography.
    coords, mapping = _points(pf)
    ones = np.asarray(jgeo.find_homography_dlt(
        jnp.asarray(coords[1:2]), jnp.asarray(mapping[1:2])))
    got = fit.homography.numpy()[1:2]
    np.testing.assert_allclose(got / np.abs(ones).max(),
                               ones / np.abs(ones).max(), rtol=0, atol=1e-4)


def test_tie_between_two_best_hypotheses_goes_to_the_first():
    # The even columns follow one homography, the odd ones (offset 25 px)
    # another: a draw wholly in either set scores N / 2. Hypothesis 7 draws
    # four spread even-column points, hypothesis 11 four odd-column ones;
    # every other hypothesis repeats a point and scores 0. Hypothesis 7's
    # inliers, the even columns, make the fit.
    pf = _field(8)
    pf[:, :, 1::2] += 25.0
    key, idx = _key_idx(9)
    idx = _repeat_point(idx, [(b, k) for b in range(B) for k in range(K)])
    idx = idx.reshape(B, K, 4)
    idx[:, 7] = [2 * W + 2, 2 * W + 28, 21 * W + 28, 21 * W + 2]
    idx[:, 11] = [3 * W + 3, 3 * W + 29, 20 * W + 29, 20 * W + 3]
    fit, counts, finite = _check(pf, key, idx.reshape(B, 4 * K),
                                 injected=True)
    assert (counts[:, 7] == N // 2).all() and (counts[:, 11] == N // 2).all()
    assert (counts.sum(-1) == N).all() and finite.sum() == 2 * B
    assert (fit.best.numpy() == 7).all()
    assert (fit.inliers.numpy().reshape(B, H, W)[:, :, 0::2]).all()


def test_draws_come_from_the_generator_when_not_injected():
    pf = torch.from_numpy(_field(11, outliers=0.1))
    coords, mapping = transac.field_points(pf)
    fits = [transac.ransac_fit(coords, mapping, generator=torch.Generator()
                               .manual_seed(s)) for s in (0, 0)]
    for a, b in zip(fits[0], fits[1]):
        assert torch.equal(a, b)
    idx = transac.draw_indices(B, N, K, torch.Generator().manual_seed(0))
    assert idx.shape == (B, 4 * K) and 0 <= int(idx.min()) and \
        int(idx.max()) < N
    assert torch.equal(transac.ransac_fit(coords, mapping, idx=idx).counts,
                       fits[0].counts)


def test_bfloat16_field_is_widened_to_float32_as_jax_widens_it():
    # A bf16 field (the PF head's output under MODEL.DTYPE bfloat16): JAX
    # adds it to its float32 pixel grid, so the mapping is float32
    # (ransac.py:73-76), and refits with float32 weights (:57); both sides
    # then fit the bf16 field's values as the float32 tests do. Rounding
    # the mapping to bf16 instead (0.125 px apart at coordinates 16-31 of
    # this 24x32 field; 0.5 px at 64-127, 2 px past 256) moves the fit.
    key, idx = _key_idx(10)
    pf = torch.from_numpy(_field(11, outliers=0.1)).to(torch.bfloat16)
    assert _port(pf.float().numpy(), idx, 'bfloat16')[0].homography.dtype \
        == torch.float32
    _check(pf.float().numpy(), key, idx, dtype='bfloat16')
