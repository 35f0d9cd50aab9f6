"""Batched homography geometry in torch (counterpart of
``bihome_tpu/geometry.py``).

Same conventions as the reference: pixel centres at integer coordinates,
origin at the top-left pixel centre, points are (x, y), images NHWC.
Function names and formulas follow the JAX module one for one, so each can
be tested against its counterpart; see there for the derivations.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from bihome_torch.ops import warp

Tensor = torch.Tensor


def image_corners(height: int, width: int, batch_size: Optional[int] = None,
                  dtype=torch.float32, device=None) -> Tensor:
    """Corner points [(0,0),(w,0),(w,h),(0,h)], optionally batched."""
    corners = torch.tensor([[0, 0], [width, 0], [width, height], [0, height]],
                           dtype=dtype, device=device)
    if batch_size is not None:
        corners = corners[None].repeat(batch_size, 1, 1)
    return corners


def _floating(t: Tensor) -> Tensor:
    """float32 for integer input; floating input keeps its precision (the
    CPU path also runs in float64, as a reference for float32)."""
    return t if t.is_floating_point() else t.float()


def _similarity(scale: Tensor, tx: Tensor, ty: Tensor) -> Tensor:
    """[B,3,3] rows (s,0,tx), (0,s,ty), (0,0,1)."""
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    return torch.stack([torch.stack([scale, zero, tx], -1),
                        torch.stack([zero, scale, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _normalization_transform(points: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-batch similarity T mapping points into ~[-1, 1]; returns
    (T [B,3,3], T applied to points [B,N,2])."""
    center = points.mean(dim=1, keepdim=True)                     # [B,1,2]
    shifted = points - center
    scale = shifted.abs().amax(dim=(1, 2)).clamp_min(1e-8)        # [B]
    normalized = shifted / scale[:, None, None]
    inv_s = 1.0 / scale
    t = _similarity(inv_s, -center[:, 0, 0] * inv_s, -center[:, 0, 1] * inv_s)
    return t, normalized


def _denormalization_transform(points: Tensor) -> Tensor:
    """Inverse of :func:`_normalization_transform`'s T for a point set."""
    center = points.mean(dim=1)                                   # [B,2]
    scale = (points - center[:, None]).abs().amax(dim=(1, 2)).clamp_min(1e-8)
    return _similarity(scale, center[:, 0], center[:, 1])


def inv3x3(m: Tensor) -> Tensor:
    """Closed-form (adjugate) batched 3x3 inverse. m: [...,3,3]."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], dim=-2)
    return adj / det[..., None, None]


def _square_to_quad(quad: Tensor) -> Tensor:
    """Closed-form homography mapping the unit square onto ``quad`` [B,4,2]
    (Heckbert '89, §2.2)."""
    x0, y0 = quad[:, 0, 0], quad[:, 0, 1]
    x1, y1 = quad[:, 1, 0], quad[:, 1, 1]
    x2, y2 = quad[:, 2, 0], quad[:, 2, 1]
    x3, y3 = quad[:, 3, 0], quad[:, 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1 = x1 - x2
    dx2 = x3 - x2
    dy1 = y1 - y2
    dy2 = y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(den.abs() < 1e-20, torch.full_like(den, 1e-20), den)
    g = (sx * dy2 - dx2 * sy) / den
    h = (dx1 * sy - sx * dy1) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    ones = torch.ones_like(a)
    return torch.stack([
        torch.stack([a, b, x0], -1),
        torch.stack([d, e, y0], -1),
        torch.stack([g, h, ones], -1),
    ], dim=-2)


def get_perspective_transform(src: Tensor, dst: Tensor) -> Tensor:
    """Exact homography mapping 4 src points onto 4 dst points.
    src/dst [B,4,2] -> H [B,3,3], composed from two closed-form
    square->quad maps on normalized coordinates."""
    src, dst = _floating(src), _floating(dst)
    t_src, src_n = _normalization_transform(src)
    _, dst_n = _normalization_transform(dst)
    h_n = _square_to_quad(dst_n) @ inv3x3(_square_to_quad(src_n))
    h_full = _denormalization_transform(dst) @ h_n @ t_src
    return _normalize_gauge(h_full)


def _normalize_gauge(h_full: Tensor) -> Tensor:
    """Scale-normalize homographies, robust to h33 -> 0: divide by h33
    unless it is tiny relative to the matrix, then by the sign-matched
    max entry (see bihome_tpu/geometry.py:_normalize_gauge)."""
    h22 = h_full[:, 2:3, 2:3]
    maxabs = h_full.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-20)
    safe = h22.abs() > 1e-5 * maxabs
    fallback = torch.where(h22 < 0, -maxabs, maxabs)
    return h_full / torch.where(safe, h22, fallback)


def four_point_to_homography(corners: Tensor, deltas: Tensor,
                             crop: bool = False) -> Tensor:
    """Homography mapping ``corners`` to ``corners + deltas`` [B,4,2]."""
    if crop:
        corners = corners - corners[:, 0:1]
    return get_perspective_transform(corners, corners + deltas)


def transform_points(homography: Tensor, points: Tensor) -> Tensor:
    """[B,3,3] x [B,N,2] -> [B,N,2]."""
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    out = torch.einsum('bij,bnj->bni', homography, pts_h)
    denom = out[..., 2:3]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    return out[..., :2] / denom


def bilinear_sample(image: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Bilinearly sample ``image`` [H,W,C] at (x, y) [N], zero padding ->
    [N,C]. Single-image form of :func:`batched_sample`'s plain path."""
    return warp.bilinear_sample_plain(image[None], x[None], y[None])[0]


def batched_sample(images: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """images [B,H,W,C], u/v [B,P] -> [B,P,C]. The warp hot path, with
    gradients into the points (and the images, when they require grad):
    the hand-written CUDA kernels on the card, the plain gather on the
    CPU (``ops/warp.BilinearSample``). A bfloat16 image is sampled in
    float32 (``ops/warp.sample``)."""
    return warp.sample(images, u, v)


def crop_integer(images: Tensor, x0: Tensor, y0: Tensor,
                 size_hw: Tuple[int, int]) -> Tensor:
    """Batched crop at per-sample integer offsets (callers guarantee they
    are in bounds). images [B,H,W,C], x0/y0 [B] -> [B,sh,sw,C]."""
    sh, sw = size_hw
    b, h, w, _ = images.shape
    if (sh, sw) == (h, w):
        return images
    dev = images.device
    rows = y0.long()[:, None] + torch.arange(sh, device=dev)       # [B,sh]
    cols = x0.long()[:, None] + torch.arange(sw, device=dev)       # [B,sw]
    bidx = torch.arange(b, device=dev)[:, None, None]
    return images[bidx, rows[:, :, None], cols[:, None, :]]


def homography_grid(homography: Tensor, target_hw: Tuple[int, int],
                    offset: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Map the target pixel grid through batched homographies.
    Returns (u, v) each [B, th*tw]; ``offset`` [B,2] shifts the grid."""
    th, tw = target_hw
    dev = homography.device
    dt = homography.dtype
    ys, xs = torch.meshgrid(torch.arange(th, dtype=dt, device=dev),
                            torch.arange(tw, dtype=dt, device=dev),
                            indexing='ij')
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(th * tw, dtype=dt, device=dev)], dim=0)
    if offset is not None:
        b = homography.shape[0]
        grid = torch.cat([grid[:2] + offset.to(dt)[..., None],
                          grid[2:].expand(b, 1, th * tw)], dim=-2)
        mapped = torch.einsum('bij,bjp->bip', homography, grid)
    else:
        mapped = torch.einsum('bij,jp->bip', homography, grid)    # [B,3,P]
    denom = mapped[:, 2]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    return mapped[:, 0] / denom, mapped[:, 1] / denom


def ones_warp_mask(u: Tensor, v: Tensor, source_hw: Tuple[int, int]
                   ) -> Tensor:
    """Closed form of warping an all-ones image: the bilinear support mask,
    exactly 1 inside, a linear ramp over the 1-pixel border band, 0
    outside (ref: bihome_tpu/geometry.py:505-522). u, v [B,P] -> [B,P]."""
    sh, sw = source_hw
    gu = torch.clamp(torch.minimum(u + 1.0, sw - u), 0.0, 1.0)
    gv = torch.clamp(torch.minimum(v + 1.0, sh - v), 0.0, 1.0)
    return gu * gv


def warp_image(image: Tensor, homography: Tensor,
               target_hw: Optional[Tuple[int, int]] = None,
               inverse: bool = True) -> Tensor:
    """Warp NHWC images by homographies (ref: src/data/utils.py:54-67):
    with ``inverse`` dst(x) = src(H·x), sampled directly with H; else
    dst(x) = src(H^-1·x), cv2.warpPerspective(img, H). image [B,H,W,C],
    homography [B,3,3] -> [B,th,tw,C] (float32 for a bfloat16 image,
    :func:`batched_sample`)."""
    if target_hw is None:
        target_hw = (image.shape[1], image.shape[2])
    sampling = homography if inverse else inv3x3(homography)
    u, v = homography_grid(sampling, target_hw)
    out = batched_sample(image, u, v)                              # [B,P,C]
    return out.reshape(image.shape[0], target_hw[0], target_hw[1],
                       image.shape[-1])


def warp_perspective(image: Tensor, m: Tensor,
                     target_hw: Optional[Tuple[int, int]] = None) -> Tensor:
    """cv2.warpPerspective / kornia.warp_perspective: dst(x) =
    src(M^-1 · x). image [B,H,W,C], m [B,3,3]."""
    return warp_image(image, m, target_hw=target_hw, inverse=False)


def _normalize_point_cloud(points: Tensor) -> Tuple[Tensor, Tensor]:
    """Zero mean, mean distance sqrt(2). Returns (normalized [B,N,2],
    transform [B,3,3])."""
    mean = points.mean(dim=1, keepdim=True)                       # [B,1,2]
    dist = torch.linalg.vector_norm(points - mean, dim=-1)        # [B,N]
    scale = math.sqrt(2.0) / dist.mean(dim=-1).clamp_min(1e-8)    # [B]
    t = _similarity(scale, -mean[:, 0, 0] * scale, -mean[:, 0, 1] * scale)
    return (points - mean) * scale[:, None, None], t


def solve_psd_unrolled(a: Tensor, b: Tensor) -> Tensor:
    """Batched SPD solve by a statically unrolled Cholesky.
    a [B,n,n], b [B,n] -> x [B,n]. Eager torch runs every scalar step as
    its own op; see PERF.md."""
    n = a.shape[-1]
    low = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[:, i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            if i == j:
                low[i][j] = torch.sqrt(s.clamp_min(1e-12))
            else:
                low[i][j] = s / low[j][j]
    y = []
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y.append(s / low[i][i])
    x: list = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return torch.stack(x, dim=-1)


def find_homography_dlt(points1: Tensor, points2: Tensor,
                        weights: Optional[Tensor] = None,
                        method: str = 'cholesky') -> Tensor:
    """Batched (weighted) normalized DLT (``bihome_tpu/geometry.py:
    606-662``). points1/points2 [B,N,2], weights [B,N] -> H [B,3,3].

    'cholesky': fix h33 = 1 and solve the 8x8 normal equations with the
    unrolled Cholesky. 'eigh': the homogeneous DLT, the eigenvector of the
    smallest eigenvalue of the 9x9 normal matrix (``torch.linalg.eigh``,
    a library call as ``jnp.linalg.eigh`` is in JAX); the h33 gauge below
    cancels its sign."""
    p1n, t1 = _normalize_point_cloud(_floating(points1))
    p2n, t2 = _normalize_point_cloud(_floating(points2))
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    w = (None if weights is None
         else torch.cat([weights, weights], dim=1).to(x.dtype))   # [B,2N]
    if method == 'cholesky':
        ax = torch.stack([x, y, ones, zeros, zeros, zeros, -x * u, -y * u],
                         -1)
        ay = torch.stack([zeros, zeros, zeros, x, y, ones, -x * v, -y * v],
                         -1)
        a = torch.cat([ax, ay], dim=1)                            # [B,2N,8]
        rhs = torch.cat([u, v], dim=1)                            # [B,2N]
        if w is not None:
            # Two operands each (the three-operand form's contraction
            # order, bit for bit on the CPU): a three-operand einsum fixes
            # the batch size in a torch.export graph.
            ata = torch.einsum('bni,bnj->bij', a, a * w[..., None])
            atb = torch.einsum('bni,bn->bi', a, w * rhs)
        else:
            ata = torch.einsum('bni,bnj->bij', a, a)
            atb = torch.einsum('bni,bn->bi', a, rhs)
        ata = ata + 1e-6 * torch.eye(8, dtype=ata.dtype, device=ata.device)
        h8 = solve_psd_unrolled(ata, atb)
        h = torch.cat([h8, torch.ones_like(h8[:, :1])],
                      dim=1).reshape(-1, 3, 3)
    elif method == 'eigh':
        ax = torch.stack([-x, -y, -ones, zeros, zeros, zeros, u * x, u * y,
                          u], -1)
        ay = torch.stack([zeros, zeros, zeros, -x, -y, -ones, v * x, v * y,
                          v], -1)
        a = torch.cat([ax, ay], dim=1)                            # [B,2N,9]
        if w is not None:
            ata = torch.einsum('bni,bnj->bij', a, a * w[..., None])
        else:
            ata = torch.einsum('bni,bnj->bij', a, a)              # [B,9,9]
        _, eigvecs = torch.linalg.eigh(ata)
        h = eigvecs[..., 0].reshape(-1, 3, 3)
    else:
        raise ValueError(method)
    h_full = inv3x3(t2) @ h @ t1
    denom = h_full[:, 2:3, 2:3]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    return h_full / denom


def mace(delta_gt: Tensor, delta_hat: Tensor) -> Tensor:
    """Mean Average Corner Error in pixels (ref: eval.py:133-134)."""
    diff = delta_gt.reshape(-1, 2) - delta_hat.reshape(-1, 2)
    return torch.linalg.vector_norm(diff, dim=-1).mean()


def calc_reprojection_error(source_points: Tensor, target_points: Tensor,
                            homography: Tensor) -> Tensor:
    """Sum of squared reprojection errors (``bihome_tpu/geometry.py:
    684-691``, ref: src/data/utils.py:139-172): source/target [N,2]
    (unbatched, as the reference), homography [3,3]."""
    transformed = transform_points(homography[None], source_points[None])[0]
    return ((transformed - target_points) ** 2).sum()
