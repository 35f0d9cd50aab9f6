"""Colour-space ops (counterpart of ``bihome_tpu/ops/color.py``): the HSV
round trip of the photometric distortion, grayscale and standardization.

The HSV pair follows cv2's float convention (H in degrees [0, 360), S in
[0, 1], V the largest channel in input units) and, like the JAX module,
takes any float range: brightness and contrast run before the round trip,
so pixels may lie below 0 or above 255 and are not clipped.
"""

from __future__ import annotations

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] float RGB -> HSV (``bihome_tpu/ops/color.py:18-36``). Hue
    ties take red before green before blue; a grey pixel (delta 0) has hue
    0 and ``v == 0`` saturation 0."""
    r, g, b = rgb.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    safe_delta = torch.where(delta == 0, 1.0, delta)
    h_r = 60.0 * (g - b) / safe_delta
    h_g = 120.0 + 60.0 * (b - r) / safe_delta
    h_b = 240.0 + 60.0 * (r - g) / safe_delta
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(delta == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h)
    safe_v = torch.where(v == 0, 1.0, v)
    s = torch.where(v == 0, 0.0, delta / safe_v)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv` (``bihome_tpu/ops/color.py:39-55``).
    The sector index is a floor modulo 6 (``jnp.mod``), so a hue of
    exactly 360 falls in sector 0."""
    h, s, v = hsv.unbind(-1)
    h60 = h / 60.0
    i = torch.floor(h60)
    f = h60 - i
    i = torch.remainder(i.to(torch.int32), 6)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)

    def select(*values):
        out = values[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out
    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def rgb_to_grayscale(rgb: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Luma grayscale with the reference weights .299/.587/.114
    (ref: src/data/transforms.py:333-354). NHWC in, NHW1 (or NHW) out."""
    gray = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    return gray[..., None] if keepdims else gray


def standardize(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(x/255 - mean) / std (ref: src/data/transforms.py:357-378)."""
    return (x.float() / 255.0 - mean) / std


def destandardize(x: torch.Tensor, mean: float = 0.443,
                  std: float = 0.129) -> torch.Tensor:
    """Inverse of :func:`standardize` on the 0..255 scale, rounded (half to
    even) and clipped to [0, 255] (``bihome_tpu/ops/color.py:70-74``;
    ref: eval.py:31-41)."""
    return torch.round((x * std + mean) * 255.0).clamp(0.0, 255.0)
