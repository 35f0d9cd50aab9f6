"""The Rethinking decoder's upsampling: a kernel-2 / stride-2 transposed
convolution, and that transposed convolution fused with the 3x3
convolution after it (counterparts of ``bihome_tpu/ops/deconv.py``:
``ConvTranspose2x2``, and ``compose_deconv2x2_conv3x3`` (``:73``),
``fused_deconv_conv3x3`` (``:317``) with ``_deconv_bias_field``
(``:216``)).

The JAX default (``BIHOME_DECONV_FUSE`` on, ``bihome_tpu/models/
blocks.py:185,212-215``) runs the pair ConvTranspose2d(2, 2) -> Conv2d(3x3)
as one convolution of a composite kernel, composed in float32 and then
rounded to the compute dtype, so at bfloat16 the upsampled intermediate is
never rounded. The port does the same at every dtype
(:func:`fused_deconv_conv3x3`; at float32 the two forms agree up to
float32 rounding, and a float64 model composes in float64). In JAX the
fused form is an XLA convolution, not a Pallas kernel; here it is one
torch convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bihome_torch import tracing
from bihome_torch.models.layers import ConvTranspose2d, cast


def conv_transpose_2x2(in_channels: int, out_channels: int,
                       bias: bool) -> ConvTranspose2d:
    """2x upsampling transposed conv; weight [in, out, 2, 2] (torch layout,
    ``bihome_tpu.models.torch_port.conv_transpose_kernel`` maps it to flax)."""
    return ConvTranspose2d(in_channels, out_channels, kernel_size=2,
                           stride=2, bias=bias)


def _compose_dtype(w: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 weights: where the composite kernel
    and the bias field are summed."""
    return torch.promote_types(w.dtype, torch.float32)


def _tap_select(device) -> torch.Tensor:
    """S [4, 3, 2]: S[u, a, d] = 1 where the 3x3 tap ``a`` of an output row
    reads the deconv phase ``d`` of the input row that the composite
    kernel's tap ``u`` = d - a + 2 covers."""
    s = torch.zeros(4, 3, 2)
    for a in range(3):
        for d in range(2):
            s[d - a + 2, a, d] = 1.0
    return tracing.to_device(s, device)


def compose_deconv2x2_conv3x3(wd: torch.Tensor,
                              w1: torch.Tensor) -> torch.Tensor:
    """The kernel K [Cin, Cout, 4, 4] (float32, float64 for float64
    weights) with

        conv_transpose2d(x, K, stride=2, padding=1)
            == conv2d(conv_transpose2d(x, wd, stride=2), w1, padding=1)

    (no biases), from wd [Cin, Cmid, 2, 2] (ConvTranspose2d) and w1
    [Cout, Cmid, 3, 3] (Conv2d): output row 2i + d - 1 + a of the 3x3 tap
    ``a`` reads input row i through the deconv phase ``d``, so it is tap
    u = d - a + 2 of a k4 / s2 transposed convolution (ref:
    bihome_tpu/ops/deconv.py:73-117, the same sums in its phase layout)."""
    dt = _compose_dtype(wd)
    s = _tap_select(wd.device).to(dt)
    w1s = torch.einsum('uad,vbe,omab->omudve', s, s, w1.to(dt))
    return torch.einsum('cmde,omudve->couv', wd.to(dt), w1s)


def deconv_bias_field(w1: torch.Tensor, bd: torch.Tensor, h: int,
                      w: int) -> torch.Tensor:
    """The deconv bias's share of conv3x3(deconv(x) + bd) at each output
    pixel, [Cout, 2h, 2w] (float32, float64 for float64 weights): the sum
    over the 3x3 taps that fall inside the 2h x 2w frame of w1 . bd (ref:
    bihome_tpu/ops/deconv.py:216-229)."""
    dt = _compose_dtype(w1)
    tb = torch.einsum('omab,m->oab', w1.to(dt), bd.to(dt))

    def tap_mask(size):
        pos = (torch.arange(2 * size, device=w1.device)[:, None]
               + torch.arange(3, device=w1.device)[None, :] - 1)
        return ((pos >= 0) & (pos < 2 * size)).to(dt)
    return torch.einsum('pa,qb,oab->opq', tap_mask(h), tap_mask(w), tb)


def fused_deconv_conv3x3(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                         w1: torch.Tensor, dtype=None) -> torch.Tensor:
    """conv3x3(pad 1, no bias)(ConvTranspose2x2(x; wd) + bd) as one
    convolution in ``dtype`` (None: the weights' own, no casts): x
    [N,Cin,H,W] -> [N,Cout,2H,2W]. The composite kernel is composed in
    float32 and rounded to ``dtype``, the bias field likewise, and added to
    the convolution's output in ``dtype``, as
    ``bihome_tpu/ops/deconv.py:317-338`` does. The gradients reach wd, bd
    and w1 through the composition in float32, the kernel's gradient
    rounded to ``dtype`` first (``_pca_bwd``'s ``dk.astype(kfull.dtype)``)."""
    h, w = x.shape[2], x.shape[3]
    kernel = cast(compose_deconv2x2_conv3x3(wd, w1), dtype)
    y = F.conv_transpose2d(cast(x, dtype), kernel, stride=2, padding=1)
    return y + cast(deconv_bias_field(w1, bd, h, w), dtype)[None]
