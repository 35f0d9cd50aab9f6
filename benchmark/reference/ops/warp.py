"""Bilinear sampling in plain torch: the 4-tap gather of each point, each
tap 0 outside the image (cv2 BORDER_CONSTANT(0), ``grid_sample``'s
``padding_mode='zeros'``). Gradients come from autograd through the
gather and the weights; no hand-written backward."""

from __future__ import annotations

from typing import Tuple

import torch


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


def sample(images: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """images [N,H,W,C], u/v [N,P] (or one row broadcast over N) ->
    [N,P,C]; a bfloat16 image is sampled in float32."""
    if images.dtype == torch.bfloat16:
        images = images.float()
    n = images.shape[0]
    return bilinear_sample_plain(images, u.expand(n, -1), v.expand(n, -1))
