"""DSAC hypothesis sampling (counterpart of ``bihome_tpu/heads/dsac.py``
:46-88). Scoring and refinement are not ported yet.

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
    are (x, y) = (i % w, i // w) and their images (x, y) + pf[i]."""
    b, h, w, _ = pf.shape
    n_points = h * w
    idx = sample_point_indices((b, hypothesis_no * points_per_hypothesis),
                               n_points, point_sampling, uniforms, generator,
                               pf.device)
    sel = torch.gather(pf.reshape(b, n_points, 2), 1,
                       idx[..., None].expand(-1, -1, 2))
    p1 = torch.stack([idx % w, idx // w], dim=-1).to(pf.dtype)
    p2 = p1 + sel
    p1 = p1.reshape(b * hypothesis_no, points_per_hypothesis, 2)
    p2 = p2.reshape(b * hypothesis_no, points_per_hypothesis, 2)
    return geometry.find_homography_dlt(p1, p2).reshape(
        b, hypothesis_no, 3, 3)
