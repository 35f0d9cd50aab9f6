"""Vectorised RANSAC homography fit, the predict postprocess of the NoOp
'all_points' head (counterpart of ``bihome_tpu/heads/ransac.py``).

K minimal 4-point hypotheses per sample, each solved in closed form
(``geometry.get_perspective_transform``), scored by their inlier count at
a reprojection threshold; the winner is refit on its inliers by the
weighted DLT. Everything is batched: no loop over the batch or the
hypotheses. Like the JAX module this is plain tensor code (XLA there, not a
Pallas kernel).

The draws are a parameter: by default ``torch.randint`` on the field's
device from ``generator``; a test passes exactly the indices that
``jax.random.randint(key, (B, 4K), 0, N)`` produced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from bihome_torch import geometry, tracing

Tensor = torch.Tensor

NUM_HYPOTHESES = 64
THRESHOLD = 10.0


class RansacFit(NamedTuple):
    """The fit and what decided it: the refit homography [B,3,3], the
    winning hypothesis [B], every hypothesis's inlier count [B,K] and the
    winner's inlier mask [B,N]."""
    homography: Tensor
    best: Tensor
    counts: Tensor
    inliers: Tensor


def draw_indices(batch: int, n_points: int, num_hypotheses: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Tensor:
    """[B, 4K] point indices uniform over [0, N), with replacement
    (``ransac.py:31``), drawn on ``device`` (the generator's device)."""
    return torch.randint(0, n_points, (batch, 4 * num_hypotheses),
                         generator=generator, device=device)


def ransac_fit(points1: Tensor, points2: Tensor,
               num_hypotheses: int = NUM_HYPOTHESES,
               threshold: float = THRESHOLD,
               idx: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None) -> RansacFit:
    """points1/points2 [B,N,2] -> :class:`RansacFit`, whose
    ``homography`` is what ``ransac_homography`` returns
    (``bihome_tpu/heads/ransac.py:21-59``).

    Hypotheses whose H is not finite (a draw that repeats a point) have no
    inliers; the winner is the first hypothesis with the most inliers; it
    is refit with its inlier mask as the DLT weights (float32, or float64
    for float64 points, as ``ransac.py:57``), or with all-ones weights if
    it has fewer than 4 inliers."""
    b, n_points, _ = points1.shape
    k = num_hypotheses
    if idx is None:
        idx = draw_indices(b, n_points, k, generator, points1.device)
    idx = tracing.to_device(idx, points1.device).long()[..., None].expand(
        -1, -1, 2)
    p1s = torch.gather(points1, 1, idx).reshape(b * k, 4, 2)
    p2s = torch.gather(points2, 1, idx).reshape(b * k, 4, 2)
    h = geometry.get_perspective_transform(p1s, p2s)              # [B*K,3,3]

    p1 = points1[:, None].expand(b, k, n_points, 2).reshape(b * k, n_points, 2)
    p2 = points2[:, None].expand(b, k, n_points, 2).reshape(b * k, n_points, 2)
    err = torch.linalg.vector_norm(geometry.transform_points(h, p1) - p2,
                                   dim=-1)
    finite = torch.isfinite(h.reshape(b * k, 9)).all(-1)
    inliers = (err < threshold) & finite[:, None]
    counts = inliers.sum(-1).reshape(b, k)

    best = torch.argmax(counts, dim=-1)                           # [B]
    best_inliers = inliers.reshape(b, k, n_points)[
        torch.arange(b, device=best.device), best]                # [B,N]
    w = best_inliers.to(torch.promote_types(points1.dtype, torch.float32))
    w = torch.where(w.sum(-1, keepdim=True) < 4, torch.ones_like(w), w)
    return RansacFit(geometry.find_homography_dlt(points1, points2, w), best,
                     counts, best_inliers)


def field_points(pf: Tensor) -> Tuple[Tensor, Tensor]:
    """PF [B,H,W,2] -> (pixel coordinates, coordinates + field), each
    [B,H*W,2] in row-major order (``ransac.py:71-76``). The field may be a
    permuted view of an NCHW tensor. The grid is float32 (float64 for a
    float64 field), as JAX's, so a bfloat16 field is widened before the
    addition: ``coords + pf`` in bf16 would round the mapping to bf16's
    spacing (0.5 px at coordinates 64-127, 2 px past 256)."""
    b, h_dim, w_dim, _ = pf.shape
    dtype = torch.promote_types(pf.dtype, torch.float32)
    ys, xs = torch.meshgrid(
        torch.arange(h_dim, dtype=dtype, device=pf.device),
        torch.arange(w_dim, dtype=dtype, device=pf.device), indexing='ij')
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)   # [N,2]
    coords = coords[None].expand(b, h_dim * w_dim, 2)
    return coords, coords + pf.reshape(b, -1, 2).to(dtype)


def fit_to_delta(fit: RansacFit, pf_shape) -> Tensor:
    """The displacement of the corners [(0,0),(W,0),(W,H),(0,H)] under the
    fit (the reference's W, H convention, not W - 1) -> [B,4,2]."""
    b, h_dim, w_dim, _ = pf_shape
    h_fit = fit.homography
    four_points = geometry.image_corners(h_dim, w_dim, batch_size=b,
                                         dtype=h_fit.dtype,
                                         device=h_fit.device)
    return geometry.transform_points(h_fit, four_points) - four_points


def perspective_field_to_delta(pf: Tensor,
                               num_hypotheses: int = NUM_HYPOTHESES,
                               threshold: float = THRESHOLD,
                               idx: Optional[Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[Tensor, Tensor]:
    """NoOpHead 'all_points' postprocess (``ransac.py:62-86``): PF
    [B,H,W,2] -> (delta [B,4,2], H [B,3,3]), a robust homography fit to
    the whole coordinate -> mapping field, read at the patch corners."""
    coords, mapping = field_points(pf)
    fit = ransac_fit(coords, mapping, num_hypotheses, threshold, idx,
                     generator)
    return fit_to_delta(fit, pf.shape), fit.homography
