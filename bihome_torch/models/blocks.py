"""Residual and upsampling blocks of the Rethinking backbone (counterpart
of ``bihome_tpu/models/blocks.py:69-114,173-233``), NCHW. BatchNorm is
:class:`bihome_torch.models.norm.BatchNorm2d` (flax's biased running
variance in training mode).

State-dict keys follow the reference (``upper_branch.j`` /
``lower_branch.j``, ref: src/backbones/utils.py:4-152), so reference
checkpoints load directly and ``bihome_tpu.models.torch_port`` maps them
onto the flax tree.
"""

from __future__ import annotations

import torch
from torch import nn

from bihome_torch.models.norm import BatchNorm2d
from bihome_torch.ops.deconv import conv_transpose_2x2


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


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
                nn.Conv2d(in_channels, features, 1, stride=stride,
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


class ResNet50DeconvBlock(nn.Module):
    """2x upsampling block, ``features`` -> ``features // 2`` channels
    (ref: src/backbones/utils.py:60-82); used by the ResNet34 flavour too."""

    def __init__(self, features: int):
        super().__init__()
        half = features // 2
        self.upper_branch = nn.Sequential(
            conv_transpose_2x2(features, features, bias=True),
            _conv3x3(features, features), BatchNorm2d(features), nn.ReLU(),
            nn.Conv2d(features, half, 1, bias=False), BatchNorm2d(half))
        self.lower_branch = nn.Sequential(
            conv_transpose_2x2(features, half, bias=False),
            BatchNorm2d(half))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.upper_branch(x) + self.lower_branch(x))
