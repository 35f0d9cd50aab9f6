"""The Rethinking decoder's 2x upsampling: a kernel-2 / stride-2
transposed convolution."""

from __future__ import annotations

import torch

from benchmark.reference.models.layers import ConvTranspose2d


def conv_transpose_2x2(in_channels: int, out_channels: int,
                       bias: bool) -> ConvTranspose2d:
    """2x upsampling transposed conv; weight [in, out, 2, 2] (torch layout,
    ``bihome_tpu.models.torch_port.conv_transpose_kernel`` maps it to flax)."""
    return ConvTranspose2d(in_channels, out_channels, kernel_size=2,
                           stride=2, bias=bias)
