"""Residual and upsampling blocks of the Rethinking backbone (counterpart
of ``bihome_tpu/models/blocks.py:69-253``), NCHW. BatchNorm is
:class:`benchmark.reference.models.norm.BatchNorm2d` (flax's biased running
variance in training mode).

State-dict keys follow the reference (``upper_branch.j`` /
``lower_branch.j``, ref: src/backbones/utils.py:4-152), so reference
checkpoints load directly and ``bihome_tpu.models.torch_port`` maps them
onto the flax tree.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.models.layers import Conv2d
from benchmark.reference.models.norm import BatchNorm2d
from benchmark.reference.ops.deconv import conv_transpose_2x2


def _conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class ResNet34ConvBlock(nn.Module):
    """Two 3x3 convs; a 1x1 projection shortcut when the width changes
    (ref: src/backbones/utils.py:85-112)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.upper_branch = nn.Sequential(
            _conv3x3(in_channels, features, stride), BatchNorm2d(features),
            nn.ReLU(), _conv3x3(features, features), BatchNorm2d(features))
        if in_channels != features:
            self.lower_branch = nn.Sequential(
                Conv2d(in_channels, features, 1, stride=stride,
                          bias=False),
                BatchNorm2d(features))
        else:
            self.lower_branch = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + self.lower_branch(x))


class ResNet34IdentityBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ref: src/backbones/utils.py:
    115-131)."""

    def __init__(self, features: int):
        super().__init__()
        self.upper_branch = nn.Sequential(
            _conv3x3(features, features), BatchNorm2d(features), nn.ReLU(),
            _conv3x3(features, features), BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + x)


class ResNet50ConvBlock(nn.Module):
    """Bottleneck block with a projection shortcut: 1x1 (strided) -> 3x3
    -> 1x1 to ``features`` (ref: src/backbones/utils.py:4-29). The middle
    width is ``in_channels // stride``, not ``features // 4``, and the
    stride sits on the first 1x1 conv and on the shortcut."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        mid = in_channels // stride
        self.upper_branch = nn.Sequential(
            Conv2d(in_channels, mid, 1, stride=stride, bias=False),
            BatchNorm2d(mid), nn.ReLU(), _conv3x3(mid, mid), BatchNorm2d(mid),
            nn.ReLU(), Conv2d(mid, features, 1, bias=False),
            BatchNorm2d(features))
        self.lower_branch = nn.Sequential(
            Conv2d(in_channels, features, 1, stride=stride, bias=False),
            BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + self.lower_branch(x))


class ResNet50IdentityBlock(nn.Module):
    """Bottleneck ``features`` -> ``features // 4`` -> ``features // 4`` ->
    ``features`` with an identity shortcut (ref: src/backbones/utils.py:
    32-57)."""

    def __init__(self, features: int):
        super().__init__()
        mid = features // 4
        self.upper_branch = nn.Sequential(
            Conv2d(features, mid, 1, bias=False), BatchNorm2d(mid),
            nn.ReLU(), _conv3x3(mid, mid), BatchNorm2d(mid), nn.ReLU(),
            Conv2d(mid, features, 1, bias=False), BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + x)


class ResNet50DeconvBlock(nn.Module):
    """2x upsampling block, ``features`` -> ``features // 2`` channels
    (ref: src/backbones/utils.py:60-82); used by both flavours (1024, 512,
    256 and 128 input channels in the ResNet50 one). The upper branch's
    deconv and 3x3 conv run as one convolution
    (``ops/deconv.fused_deconv_conv3x3``, the JAX default,
    ``bihome_tpu/models/blocks.py:185-215``), on the same parameters."""

    compute_dtype = None

    def __init__(self, features: int):
        super().__init__()
        half = features // 2
        self.upper_branch = nn.Sequential(
            conv_transpose_2x2(features, features, bias=True),
            _conv3x3(features, features), BatchNorm2d(features), nn.ReLU(),
            Conv2d(features, half, 1, bias=False), BatchNorm2d(half))
        self.lower_branch = nn.Sequential(
            conv_transpose_2x2(features, half, bias=False),
            BatchNorm2d(half))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + self.lower_branch(x))


class ResNet34DeconvBlock(nn.Module):
    """2x upsampling block, ResNet34 flavour, ``features`` -> ``features //
    2`` channels: a 2x2 / stride-2 deconv with bias, a 3x3 conv and BN on
    the upper branch, a deconv without bias and BN on the lower (ref:
    src/backbones/utils.py:134-152; ``bihome_tpu/models/blocks.py:236-253``).
    No shipped config builds it; it completes the block library. Its
    flax names carry over with ``models/weights.block_state_dict`` and
    ``weights._DECONV34``."""

    def __init__(self, features: int):
        super().__init__()
        half = features // 2
        self.upper_branch = nn.Sequential(
            conv_transpose_2x2(features, half, bias=True),
            _conv3x3(half, half), BatchNorm2d(half))
        self.lower_branch = nn.Sequential(
            conv_transpose_2x2(features, half, bias=False),
            BatchNorm2d(half))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + self.lower_branch(x))
