"""DSAC hypothesis sampling and the predict refit (counterparts of
``bihome_tpu/heads/dsac.py:46-88, 139-175``). Scoring of more than one
hypothesis is not ported yet.

The uniform draws are a parameter: by default they come from a
``torch.Generator``, and a test can pass exactly the values that
``jax.random.uniform(key, shape)`` produced.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bihome_torch import geometry

Tensor = torch.Tensor


def sample_point_indices(shape: Sequence[int], n_points: int,
                         point_sampling: str,
                         uniforms: Optional[Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         device='cpu') -> Tensor:
    """Draw DSAC point indices, int64 of ``shape``.

    'reference-weighted': P(i) ∝ i on [1, N-1], index 0 never drawn (the
    reference's ``torch.multinomial(arange(N))``), by exact inverse CDF:
    k = ceil((sqrt(1 + 4uT) - 1) / 2) with T = (N-1)N, clipped to
    [1, N-1]. 'uniform': uniform over [0, N).
    """
    if point_sampling == 'reference-weighted':
        if uniforms is None:
            uniforms = torch.rand(tuple(shape), generator=generator,
                                  dtype=torch.float32)
        uniforms = uniforms.to(device)
        total = float((n_points - 1) * n_points)
        k = torch.ceil((torch.sqrt(1.0 + 4.0 * uniforms * total) - 1.0) / 2.0)
        return k.long().clamp(1, n_points - 1)
    if point_sampling == 'uniform':
        if uniforms is not None:
            raise ValueError("'uniform' point sampling draws integers; "
                             'uniforms cannot be injected')
        return torch.randint(0, n_points, tuple(shape),
                             generator=generator).to(device)
    raise ValueError(point_sampling)


def sample_hypotheses_from_pf(pf: Tensor, hypothesis_no: int,
                              points_per_hypothesis: int,
                              point_sampling: str,
                              uniforms: Optional[Tensor] = None,
                              generator: Optional[torch.Generator] = None
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
                               pf.device)
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
