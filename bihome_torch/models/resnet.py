"""Torchvision-layout ResNet, truncated (counterpart of
``bihome_tpu/models/resnet.py:31-154``), NCHW.

The port uses it as the frozen biHomE auxiliary extractor: resnet34 cut
after ``output_layer`` (1 for every shipped config), with a 1-channel
stem. The reference repeats the grayscale patch to 3 channels for the
ImageNet stem; the three channels are equal, so the stem kernel summed
over its input channels gives the same result on the 1-channel patch
(``bihome_tpu/heads/assembled.py:88-98``). State-dict keys are
torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1``, ...,
``layerK.0.downsample.{0,1}``).
"""

from __future__ import annotations

import torch
from torch import nn

from bihome_torch.models.norm import BatchNorm2d
from bihome_torch.ops.pool import max_pool_3x3_s2

_ARCHS = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    """Two 3x3 convs, expansion 1; a 1x1 projection when the stride or
    width changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or in_channels != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, features, 1, stride=stride,
                          bias=False),
                BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """BasicBlock ResNet feature extractor cut after ``output_layer``
    (k in 1..4 -> the map after layer k, [N, C, H/2^(k+1), W/2^(k+1)]).
    The classifier head is not ported: every caller truncates."""

    def __init__(self, arch: str = 'resnet34', output_layer: int = 1,
                 in_channels: int = 1):
        super().__init__()
        if arch not in _ARCHS:
            raise ValueError(f'not ported yet: auxiliary resnet {arch!r}')
        if output_layer not in (1, 2, 3, 4):
            raise ValueError('not ported yet: an untruncated ResNet '
                             f'(output_layer={output_layer!r})')
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(64)
        features, cin = 64, 64
        for stage, blocks in enumerate(_ARCHS[arch][:output_layer]):
            layer = []
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                layer.append(BasicBlock(cin, features, stride))
                cin = features
            self.add_module(f'layer{stage + 1}', nn.Sequential(*layer))
            features *= 2
        self.output_layer = output_layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x))))
        for k in range(1, self.output_layer + 1):
            x = getattr(self, f'layer{k}')(x)
        return x

