"""Batched bilinear sampling with zero padding — the warp hot path.

``bilinear_sample_batched(images [N,H,W,C], u [N,P], v [N,P]) -> [N,P,C]``
is the counterpart of ``bihome_tpu/ops/warp_pallas.py:tent_sample_batched``
(the TPU kernel ``_fwd_kernel``) and equals
``bihome_tpu/geometry.py:bilinear_sample`` per image. A CPU tensor takes
:func:`bilinear_sample_plain`; a CUDA tensor launches the hand-written
kernel ``csrc/warp.cu`` (see its header for the H100 bound and design) or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from bihome_torch.ops import _cuda

_SIGNATURES = {'bilinear_sample': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_longlong, ctypes.c_void_p]}


def bilinear_sample_plain(images: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain-torch 4-tap gather; each tap contributes 0 outside the image
    (cv2 BORDER_CONSTANT(0) / grid_sample padding_mode='zeros')."""
    n, h, w, c = images.shape
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
    flat = images.reshape(n, h * w, c)

    def tap(yi, xi, wgt):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)          # [N,P]
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * (wgt * valid)[..., None]

    return (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
            + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))


def bilinear_sample_batched(images: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """images [N,H,W,C] float32, u/v [N,P] float32 -> [N,P,C]."""
    if images.device.type == 'cpu':
        return bilinear_sample_plain(images, u, v)
    _cuda.check_cuda_tensor(images, 'images', 4)
    _cuda.check_cuda_tensor(u, 'u', 2)
    _cuda.check_cuda_tensor(v, 'v', 2)
    n, h, w, c = images.shape
    if u.shape != v.shape or u.shape[0] != n:
        raise ValueError(f'u/v must be [N,P] with N={n}, got '
                         f'{tuple(u.shape)} and {tuple(v.shape)}')
    p = u.shape[1]
    out = torch.empty((n, p, c), dtype=torch.float32, device=images.device)
    lib = _cuda.library('warp', _SIGNATURES)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.bilinear_sample(images.data_ptr(), u.data_ptr(),
                                 v.data_ptr(), out.data_ptr(), n, h, w, c, p,
                                 stream)
    _cuda.check_status(status, 'bilinear_sample')
    bilinear_sample_batched.launches += 1
    return out


bilinear_sample_batched.launches = 0
