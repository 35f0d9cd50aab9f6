"""Kernel-2/stride-2 transposed convolution (counterpart of
``bihome_tpu/ops/deconv.py:ConvTranspose2x2``).

The port runs the plain two-op decoder form, ConvTranspose2d(2, 2) then
Conv2d(3x3). The JAX default fuses the pair into one phase convolution
(``fused_deconv_conv3x3``), an exact reparameterisation of the same
parameters; that fused form is not ported yet.
"""

from __future__ import annotations

from torch import nn


def conv_transpose_2x2(in_channels: int, out_channels: int,
                       bias: bool) -> nn.ConvTranspose2d:
    """2x upsampling transposed conv; weight [in, out, 2, 2] (torch layout,
    ``bihome_tpu.models.torch_port.conv_transpose_kernel`` maps it to flax)."""
    return nn.ConvTranspose2d(in_channels, out_channels, kernel_size=2,
                              stride=2, bias=bias)
