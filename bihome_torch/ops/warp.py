"""Batched bilinear sampling with zero padding — the warp hot path.

``bilinear_sample_batched(images [N,H,W,C], u [N,P], v [N,P]) -> [N,P,C]``
is the counterpart of ``bihome_tpu/ops/warp_pallas.py:tent_sample_batched``
(the TPU kernel ``_fwd_kernel``) and equals
``bihome_tpu/geometry.py:bilinear_sample`` per image. Its two gradients
are the counterparts of the same module's ``_bwd_uv_kernel``
(:func:`bilinear_sample_bwd_uv`) and ``_bwd_img_kernel``
(:func:`bilinear_sample_bwd_img`); :class:`BilinearSample` ties the three
together for autograd. Each function takes its plain-torch version for a
CPU tensor and launches its hand-written kernel in ``csrc/warp.cu`` (see
the header of each for the H100 bound and design) for a CUDA tensor, or
raises.

Derivative convention (the TPU one, ``warp_pallas.py:84-86`` and
``geometry._tent_dw``): the tent weight's derivative is 0 at distance 0
and at distance 1, so ``du`` is 0 where ``u`` is an exact integer and
``dv`` where ``v`` is. Off those points it equals the derivative of the
floor-based gather.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bihome_torch.ops import _cuda

_SIGNATURES = {
    'bilinear_sample': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
       ctypes.c_void_p],
    'bilinear_sample_bwd_uv': [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_longlong, ctypes.c_void_p],
    'bilinear_sample_bwd_img': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
       ctypes.c_void_p],
}


def _taps(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    """The 4 bilinear taps of each point: ``(fx, fy, [(flat index [N,P],
    valid [N,P], wy-or-wx weights), ...])`` in the order (y0,x0),
    (y0,x0+1), (y0+1,x0), (y0+1,x0+1); weights are those of the forward."""
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    wx1 = u - x0f
    wy1 = v - y0f
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    # Beyond one pixel outside every tap is invalid; clamping first keeps
    # the integer conversion defined for huge coordinates.
    x0 = x0f.clamp(-2, w + 1).long()
    y0 = y0f.clamp(-2, h + 1).long()
    taps = []
    for yi, xi, wgt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                        (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)           # [N,P]
        taps.append((idx, valid, wgt))
    return (wx0, wx1, wy0, wy1), taps


def _gather(flat: torch.Tensor, idx: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """flat [N,HW,C] at idx [N,P] -> [N,P,C], 0 where not valid."""
    c = flat.shape[-1]
    vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
    return vals * valid[..., None]


def bilinear_sample_plain(images: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain-torch 4-tap gather; each tap contributes 0 outside the image
    (cv2 BORDER_CONSTANT(0) / grid_sample padding_mode='zeros')."""
    n, h, w, c = images.shape
    _, taps = _taps(h, w, u, v)
    flat = images.reshape(n, h * w, c)
    out = None
    for idx, valid, wgt in taps:
        term = _gather(flat, idx, valid) * wgt[..., None]
        out = term if out is None else out + term
    return out


def bilinear_sample_bwd_uv_plain(images: torch.Tensor, u: torch.Tensor,
                                 v: torch.Tensor, g: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(du, dv) [N,P] for the cotangent g [N,P,C]: the difference of the
    forward's taps, 0 where the coordinate is an exact integer."""
    n, h, w, c = images.shape
    (wx0, wx1, wy0, wy1), taps = _taps(h, w, u, v)
    flat = images.reshape(n, h * w, c)
    t00, t01, t10, t11 = (_gather(flat, idx, valid)
                          for idx, valid, _ in taps)
    du = ((wy0[..., None] * (t01 - t00) + wy1[..., None] * (t11 - t10))
          * g).sum(-1)
    dv = ((wx0[..., None] * (t10 - t00) + wx1[..., None] * (t11 - t01))
          * g).sum(-1)
    zero = torch.zeros((), dtype=du.dtype, device=du.device)
    return (torch.where(wx1 == 0, zero, du), torch.where(wy1 == 0, zero, dv))


def bilinear_sample_bwd_img_plain(u: torch.Tensor, v: torch.Tensor,
                                  g: torch.Tensor,
                                  image_shape: Tuple[int, int, int, int]
                                  ) -> torch.Tensor:
    """dimg [N,H,W,C] = the forward's tap weights times g [N,P,C],
    scattered onto the taps inside the image."""
    n, h, w, c = image_shape
    _, taps = _taps(h, w, u, v)
    offset = (torch.arange(n, device=u.device) * (h * w))[:, None]
    dimg = torch.zeros((n * h * w, c), dtype=g.dtype, device=g.device)
    for idx, valid, wgt in taps:
        vals = g * (wgt * valid)[..., None]
        dimg.index_add_(0, (idx + offset).reshape(-1), vals.reshape(-1, c))
    return dimg.reshape(n, h, w, c)


def touched_pixels(u: torch.Tensor, v: torch.Tensor, h: int, w: int) -> int:
    """Pixels, over all images, that some in-bounds tap of the points
    u, v [N,P] reads: what a warp must read of its source on these points
    (the bytes bound of a warp that touches part of each image)."""
    _, taps = _taps(h, w, u, v)
    offset = torch.arange(u.shape[0], device=u.device)[:, None] * (h * w)
    seen = torch.zeros(u.shape[0] * h * w, dtype=torch.bool, device=u.device)
    for idx, valid, _ in taps:
        seen[(idx + offset)[valid]] = True
    return int(seen.sum())


def _check_points(images_shape, u, v, g=None, contiguous=True) -> int:
    n = images_shape[0]
    _cuda.check_cuda_tensor(u, 'u', 2, contiguous=contiguous)
    _cuda.check_cuda_tensor(v, 'v', 2, contiguous=contiguous)
    if u.shape != v.shape or u.shape[0] != n:
        raise ValueError(f'u/v must be [N,P] with N={n}, got '
                         f'{tuple(u.shape)} and {tuple(v.shape)}')
    if g is not None:
        _cuda.check_cuda_tensor(g, 'g', 3)
        if g.shape != (n, u.shape[1], images_shape[3]):
            raise ValueError(f'g must be [N,P,C] = {(n, u.shape[1])}+C, got '
                             f'{tuple(g.shape)}')
    return u.shape[1]


def bilinear_sample_batched(images: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """images [N,H,W,C] float32, u/v [N,P] float32 -> [N,P,C]. On the card
    u and v may be contiguous or one row broadcast over the batch
    (:func:`uv_batch_stride`). ``last_kernel`` holds the kernel the last
    call ran: C for the kernel of C = 1-4, 0 for the C > 1 kernel's loop
    over any other C, -1 for the generic form (past the kernels' 32-bit
    guards); the last two count in ``generic_launches`` too."""
    if images.device.type == 'cpu':
        return bilinear_sample_plain(images, u, v)
    _cuda.check_cuda_tensor(images, 'images', 4)
    p = _check_points(images.shape, u, v, contiguous=False)
    stride = uv_batch_stride(u, v)
    n, h, w, c = images.shape
    out = torch.empty((n, p, c), dtype=torch.float32, device=images.device)
    lib = _cuda.library('warp', _SIGNATURES)
    chosen = ctypes.c_int(0)
    status = lib.bilinear_sample(images.data_ptr(), u.data_ptr(),
                                 v.data_ptr(), out.data_ptr(), n, h, w, c, p,
                                 stride, ctypes.byref(chosen),
                                 _cuda.stream_ptr(images.device.index))
    _cuda.check_status(status, 'bilinear_sample')
    bilinear_sample_batched.launches += 1
    bilinear_sample_batched.last_kernel = chosen.value
    if chosen.value <= 0:
        bilinear_sample_batched.generic_launches += 1
    return out


def bilinear_sample_bwd_uv(images: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(du, dv) [N,P] of sum(g * bilinear_sample(images, u, v))."""
    if images.device.type == 'cpu':
        return bilinear_sample_bwd_uv_plain(images, u, v, g)
    _cuda.check_cuda_tensor(images, 'images', 4)
    p = _check_points(images.shape, u, v, g)
    n, h, w, c = images.shape
    du = torch.empty((n, p), dtype=torch.float32, device=images.device)
    dv = torch.empty_like(du)
    lib = _cuda.library('warp', _SIGNATURES)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.bilinear_sample_bwd_uv(
        images.data_ptr(), u.data_ptr(), v.data_ptr(), g.data_ptr(),
        du.data_ptr(), dv.data_ptr(), n, h, w, c, p, stream)
    _cuda.check_status(status, 'bilinear_sample_bwd_uv')
    bilinear_sample_bwd_uv.launches += 1
    return du, dv


def uv_batch_stride(u: torch.Tensor, v: torch.Tensor) -> int:
    """K3's and K5's stride between samples' points of u/v [N,P] on the
    card: P where both are contiguous, 0 where both broadcast one row over
    the batch (strides (0, 1), as ``expand`` gives). Raises on any other
    layout."""
    strides = []
    for t, name in ((u, 'u'), (v, 'v')):
        if t.is_contiguous():
            strides.append(t.shape[1])
        elif t.stride() == (0, 1):
            strides.append(0)
        else:
            raise ValueError(f'{name} must be contiguous or one row broadcast '
                             f'over the batch (strides (0, 1)), got strides '
                             f'{t.stride()}')
    if strides[0] != strides[1]:
        raise ValueError('u and v must share their layout (both contiguous or '
                         'both broadcast over the batch)')
    return strides[0]


def bilinear_sample_bwd_img(u: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor,
                            image_shape: Tuple[int, int, int, int],
                            cluster: int = 0) -> torch.Tensor:
    """dimg [N,H,W,C] of sum(g * bilinear_sample(images, u, v)). On the
    card u and v may be contiguous or one row broadcast over the batch
    (:func:`uv_batch_stride`); a sample whose dimg fits in a block's shared
    memory takes the cluster kernel (one launch, no memset), a larger one
    the generic scatter (counted in ``generic_launches`` too). The shared
    atomics add in no fixed order. ``cluster`` forces the blocks of a
    sample's cluster (1-4; 0: the kernel's rule), for tests and profiles;
    ``last_cluster`` holds the count the last call ran (0: generic)."""
    if u.device.type == 'cpu':
        return bilinear_sample_bwd_img_plain(u, v, g, image_shape)
    n, h, w, c = image_shape
    p = _check_points(image_shape, u, v, g, contiguous=False)
    stride = uv_batch_stride(u, v)
    if not 0 <= cluster <= 4:
        raise ValueError(f'cluster must be 0-4, got {cluster}')
    dimg = torch.empty((n, h, w, c), dtype=torch.float32, device=g.device)
    lib = _cuda.library('warp', _SIGNATURES)
    chosen = ctypes.c_int(0)
    status = lib.bilinear_sample_bwd_img(
        u.data_ptr(), v.data_ptr(), g.data_ptr(), dimg.data_ptr(), n, h, w,
        c, p, stride, cluster, ctypes.byref(chosen),
        _cuda.stream_ptr(g.device.index))
    _cuda.check_status(status, 'bilinear_sample_bwd_img')
    bilinear_sample_bwd_img.launches += 1
    bilinear_sample_bwd_img.last_cluster = chosen.value
    if chosen.value == 0:
        bilinear_sample_bwd_img.generic_launches += 1
    return dimg


bilinear_sample_batched.launches = 0
bilinear_sample_batched.generic_launches = 0
bilinear_sample_batched.last_kernel = 0
bilinear_sample_bwd_uv.launches = 0
bilinear_sample_bwd_img.launches = 0
bilinear_sample_bwd_img.generic_launches = 0
bilinear_sample_bwd_img.last_cluster = 0


def _broadcast_or_contiguous(u: torch.Tensor, v: torch.Tensor):
    """u, v as K3 and K5 read them: as given where both broadcast one row
    over the batch (the upsample grid), else contiguous."""
    if u.stride() == (0, 1) and v.stride() == (0, 1):
        return u, v
    return u.contiguous(), v.contiguous()


class BilinearSample(torch.autograd.Function):
    """Differentiable :func:`bilinear_sample_batched`: forward K3, backward
    K4 for the points and, only when the images require grad, K5. Saves the
    caller's u and v: K3 and K5 take a grid broadcast over the batch as it
    is (one row read, not N; no [N,P] copy), K4 contiguous copies."""

    @staticmethod
    def forward(ctx, images, u, v):
        ctx.save_for_backward(images, u, v)
        return bilinear_sample_batched(images, *_broadcast_or_contiguous(u, v))

    @staticmethod
    def backward(ctx, g):
        images, u, v = ctx.saved_tensors
        g = g.contiguous()
        dimg = du = dv = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            du, dv = bilinear_sample_bwd_uv(images, u.contiguous(),
                                            v.contiguous(), g)
        if ctx.needs_input_grad[0]:
            dimg = bilinear_sample_bwd_img(*_broadcast_or_contiguous(u, v), g,
                                           tuple(images.shape))
        return dimg, du, dv


def sample(images: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """:class:`BilinearSample` on images [N,H,W,C], u/v [N,P] -> [N,P,C].
    A bfloat16 image is upcast to float32 first and sampled by the float32
    kernels, as ``bihome_tpu/ops/warp_pallas.py:214-217`` upcasts before
    the Pallas kernels: the bf16 paths warp with the Pallas kernel's (and
    the CPU gather's) arithmetic, not with XLA's bf16 tent contraction
    (``bihome_tpu/geometry.py:_tent_c1``, the TPU's default warp)."""
    if images.dtype == torch.bfloat16:
        images = images.float()
    return BilinearSample.apply(images.contiguous(), u, v)
