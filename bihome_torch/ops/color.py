"""Grayscale and standardization (counterpart of ``bihome_tpu/ops/color.py``
:58-67). The HSV half used by photometric distortion is not ported yet."""

from __future__ import annotations

import torch


def rgb_to_grayscale(rgb: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Luma grayscale with the reference weights .299/.587/.114
    (ref: src/data/transforms.py:333-354). NHWC in, NHW1 (or NHW) out."""
    gray = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    return gray[..., None] if keepdims else gray


def standardize(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(x/255 - mean) / std (ref: src/data/transforms.py:357-378)."""
    return (x.float() / 255.0 - mean) / std
