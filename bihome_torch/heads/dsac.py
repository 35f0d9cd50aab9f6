"""DSAC hypothesis sampling, scoring and refits (counterpart of
``bihome_tpu/heads/dsac.py``; ref: src/heads/ransac_utils.py:26-161).

The uniform draws are a parameter: by default they come from a
``torch.Generator``, and a test can pass exactly the values that
``jax.random.uniform(key, shape)`` produced.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from bihome_torch import geometry

Tensor = torch.Tensor


def sample_point_indices(shape: Sequence[int], n_points: int,
                         point_sampling: str,
                         uniforms: Optional[Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         device='cpu',
                         rows: Optional[Tuple[int, int]] = None) -> Tensor:
    """Draw DSAC point indices, int64 of ``shape``.

    'reference-weighted': P(i) ∝ i on [1, N-1], index 0 never drawn (the
    reference's ``torch.multinomial(arange(N))``), by exact inverse CDF:
    k = ceil((sqrt(1 + 4uT) - 1) / 2) with T = (N-1)N, clipped to
    [1, N-1]. 'uniform': uniform over [0, N). With ``rows`` = (lo, total)
    the B = ``shape[0]`` samples are rows [lo, lo + B) of a global batch
    of ``total`` (a rank's slice): the draws are the global batch's, of
    which those rows are kept.
    """
    lo, whole = rows if rows is not None else (0, shape[0])
    drawn = (whole, *shape[1:])
    keep = slice(lo, lo + shape[0])
    if point_sampling == 'reference-weighted':
        if uniforms is None:
            uniforms = torch.rand(drawn, generator=generator,
                                  dtype=torch.float32)[keep]
        uniforms = uniforms.to(device)
        total = float((n_points - 1) * n_points)
        k = torch.ceil((torch.sqrt(1.0 + 4.0 * uniforms * total) - 1.0) / 2.0)
        return k.long().clamp(1, n_points - 1)
    if point_sampling == 'uniform':
        if uniforms is not None:
            raise ValueError("'uniform' point sampling draws integers; "
                             'uniforms cannot be injected')
        return torch.randint(0, n_points, drawn,
                             generator=generator)[keep].to(device)
    raise ValueError(point_sampling)


def sample_hypotheses(points1: Tensor, points2: Tensor, hypothesis_no: int,
                      points_per_hypothesis: int,
                      point_sampling: str = 'reference-weighted',
                      uniforms: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      rows: Optional[Tuple[int, int]] = None) -> Tensor:
    """Sample point subsets of the clouds points1/points2 [B,N,2] and fit
    each with the DLT -> homographies [B,n,3,3] (``dsac.py:23-43``). The
    draws [B, n * points_per_hypothesis] as :func:`sample_point_indices`
    takes them (``rows`` too); hypothesis i of sample b is the i-th run of
    ``points_per_hypothesis`` indices."""
    b, n_points, _ = points1.shape
    idx = sample_point_indices((b, hypothesis_no * points_per_hypothesis),
                               n_points, point_sampling, uniforms, generator,
                               points1.device, rows)
    gather = idx[..., None].expand(-1, -1, 2)
    p1 = torch.gather(points1, 1, gather).reshape(
        b * hypothesis_no, points_per_hypothesis, 2)
    p2 = torch.gather(points2, 1, gather).reshape(
        b * hypothesis_no, points_per_hypothesis, 2)
    return geometry.find_homography_dlt(p1, p2).reshape(
        b, hypothesis_no, 3, 3)


def sample_hypotheses_from_pf(pf: Tensor, hypothesis_no: int,
                              points_per_hypothesis: int,
                              point_sampling: str,
                              uniforms: Optional[Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              rows: Optional[Tuple[int, int]] = None
                              ) -> Tensor:
    """Sample point subsets of the perspective field and fit each with the
    DLT. pf [B,h,w,2] NHWC -> homographies [B,n,3,3]; the sampled points
    are (x, y) = (i % w, i // w) and their images (x, y) + pf[i]. A
    bfloat16 field's values go to float32 at the points (float32
    coordinates plus the sampled values, ``bihome_tpu/heads/dsac.py:82-84``),
    so the DLT and its homographies are float32 (float64 for a float64
    field)."""
    b, h, w, _ = pf.shape
    n_points = h * w
    idx = sample_point_indices((b, hypothesis_no * points_per_hypothesis),
                               n_points, point_sampling, uniforms, generator,
                               pf.device, rows)
    sel = torch.gather(pf.reshape(b, n_points, 2), 1,
                       idx[..., None].expand(-1, -1, 2))
    p1 = torch.stack([idx % w, idx // w], dim=-1).to(
        torch.promote_types(pf.dtype, torch.float32))
    p2 = p1 + sel
    p1 = p1.reshape(b * hypothesis_no, points_per_hypothesis, 2)
    p2 = p2.reshape(b * hypothesis_no, points_per_hypothesis, 2)
    return geometry.find_homography_dlt(p1, p2).reshape(
        b, hypothesis_no, 3, 3)


def refine_delta_on_pf(pf: Tensor, delta_hat: Tensor, threshold: float = 3.0,
                       iters: int = 1) -> Tensor:
    """Robust all-points refit of a predicted corner delta
    (MODEL.HEAD.DSAC_PREDICT_REFINE, ``bihome_tpu/heads/dsac.py:139-175``):
    ``iters`` IRLS rounds, each fitting one homography to all H*W
    correspondences (x, y) -> (x, y) + pf with the weighted DLT, the
    weights ``relu(1 - err / threshold) + 1e-3`` of the previous fit's
    residuals (the first round's: the homography of ``delta_hat``).
    pf [B,h,w,2] NHWC, delta_hat [B,4,2] -> refined [B,4,2] in
    delta_hat's dtype. Coordinates and mapping are float32 (a bf16 field
    widens, as in JAX; a float64 field stays float64)."""
    b, h, w, _ = pf.shape
    dtype = torch.promote_types(pf.dtype, torch.float32)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=pf.device),
                            torch.arange(w, dtype=dtype, device=pf.device),
                            indexing='ij')
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    coords = coords[None].expand(b, h * w, 2)
    mapping = coords + pf.reshape(b, -1, 2).to(dtype)
    fp = geometry.image_corners(h, w, batch_size=b, dtype=dtype,
                                device=pf.device)
    h_ref = geometry.four_point_to_homography(fp, delta_hat.to(dtype))
    for _ in range(iters):
        err = torch.linalg.vector_norm(
            geometry.transform_points(h_ref, coords) - mapping, dim=-1)
        # No weight past the inlier threshold; the floor keeps the normal
        # equations well posed when every point is rejected.
        wgt = torch.relu(1.0 - err / threshold) + 1e-3
        h_ref = geometry.find_homography_dlt(coords, mapping, wgt)
    refined = geometry.transform_points(h_ref, fp) - fp
    return refined.to(delta_hat.dtype)


def _per_hypothesis(points: Tensor, n: int) -> Tensor:
    """[B,N,2] -> [B*n,N,2], each sample's cloud once per hypothesis."""
    b, n_points, _ = points.shape
    return points[:, None].expand(b, n, n_points, 2).reshape(b * n,
                                                            n_points, 2)


def score_hypotheses(points1: Tensor, points2: Tensor, homographies: Tensor,
                     scoring_method: str = 'repr_error',
                     distance_threshold: float = 3.0,
                     distance_beta: float = 1.0,
                     score_cnn: Optional[Callable[[Tensor], Tensor]] = None
                     ) -> Tuple[Tensor, Tensor]:
    """Score each hypothesis and return (softmax(-scores) over the
    hypotheses [B,n], the reprojection tensor [B,n,N] or [B,n,N,2])
    (``dsac.py:91-136``, ref: ransac_utils.py:76-128). points [B,N,2],
    homographies [B,n,3,3]. The methods, on the error e of each point
    under its hypothesis:

    * 'repr_error': the sum of the L1 errors |e|_1;
    * 'inliers_ratio': the share of points with |e|_2 < threshold. Through
      softmax(-ratio) the hypothesis with FEWER inliers weighs more: the
      reference's sign (ransac_utils.py:126), kept;
    * 'soft_inliers_ratio': the sum of sigmoid(beta (|e|_2 - threshold));
    * 'score_cnn': ``score_cnn`` of the [B*n, sqrt(N), sqrt(N), 2] NHWC
      error image, one score each."""
    b, n_points, _ = points1.shape
    n = homographies.shape[1]
    p1 = _per_hypothesis(points1, n)
    p2 = _per_hypothesis(points2, n)
    p1_t = geometry.transform_points(homographies.reshape(b * n, 3, 3), p1)
    if scoring_method == 'repr_error':
        err = (p1_t - p2).abs().sum(-1)                           # [B*n,N]
        scores = err.sum(-1).reshape(b, n)
        reproj = err.reshape(b, n, n_points)
    elif scoring_method == 'inliers_ratio':
        err = torch.linalg.vector_norm(p1_t - p2, dim=-1)
        scores = (err < distance_threshold).to(err.dtype).mean(-1).reshape(b, n)
        reproj = err.reshape(b, n, n_points)
    elif scoring_method == 'soft_inliers_ratio':
        err = torch.linalg.vector_norm(p1_t - p2, dim=-1)
        soft = torch.sigmoid(distance_beta * (err - distance_threshold))
        scores = soft.sum(-1).reshape(b, n)
        reproj = soft.reshape(b, n, n_points)
    elif scoring_method == 'score_cnn':
        err = p1_t - p2                                           # [B*n,N,2]
        side = int(round(n_points ** 0.5))
        scores = score_cnn(err.reshape(b * n, side, side, 2)).reshape(b, n)
        reproj = err.reshape(b, n, n_points, 2)
    else:
        raise ValueError(scoring_method)
    return torch.softmax(-scores, dim=-1), reproj


def refine_hypotheses(points1: Tensor, points2: Tensor, distances: Tensor,
                      hypothesis_no: int) -> Tensor:
    """Weighted-DLT refit of every hypothesis to all points with weights
    1 - distance (``dsac.py:177-189``, ref: ransac_utils.py:130-145; no
    shipped config calls it). points [B,N,2], distances [B,n,N] ->
    [B,n,3,3]."""
    b = points1.shape[0]
    n = hypothesis_no
    h = geometry.find_homography_dlt(
        _per_hypothesis(points1, n), _per_hypothesis(points2, n),
        (1.0 - distances).reshape(b * n, -1))
    return h.reshape(b, n, 3, 3)
