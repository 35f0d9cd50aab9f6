"""Torchvision-layout ResNet (counterpart of
``bihome_tpu/models/resnet.py:31-154``), NCHW: resnet18/34 of
``BasicBlock``s, resnet50/101/152 of ``Bottleneck``s (torchvision v1.5:
the stride on the 3x3 conv). Used three ways:

* the frozen biHomE auxiliary extractor: MODEL.HEAD.AUXILIARY_RESNET
  (resnet34 in every shipped config) cut after ``output_layer`` (1 for
  every shipped config), with a 1-channel stem.
  The reference repeats the grayscale patch to 3 channels for the ImageNet
  stem; the three channels are equal, so the stem kernel summed over its
  input channels gives the same result on the 1-channel patch
  (``bihome_tpu/heads/assembled.py:88-98``);
* whole (``output_layer=None``): the 'ResNet34' regression backbone's
  resnet34 with a 2-channel stem and an 8-unit ``fc``
  (``bihome_tpu/models/backbones.py:109-136``), the DSAC score CNN's
  resnet18, and the RotNet pretext's resnet34 with a 4-unit ``fc``
  (``benchmark.reference.pretrain_aux``).

State-dict keys are torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1``,
..., ``layerK.B.conv3``/``bn3`` in a bottleneck,
``layerK.0.downsample.{0,1}``, ``fc``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.models.layers import Conv2d, Linear
from benchmark.reference.models.norm import BatchNorm2d
from benchmark.reference.ops.pool import max_pool_3x3_s2


class BasicBlock(nn.Module):
    """Two 3x3 convs, expansion 1; a 1x1 projection when the stride or
    width changes."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or in_channels != features:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, features, 1, stride=stride,
                          bias=False),
                BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3 (strided), 1x1 to ``features * 4``; a 1x1 projection when
    the stride or width changes (``bihome_tpu/models/resnet.py:64-101``)."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, out, 1, stride=stride, bias=False),
                BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


# arch -> (block, blocks per stage) (``resnet.py:104-110``).
_ARCHS = {'resnet18': (BasicBlock, (2, 2, 2, 2)),
          'resnet34': (BasicBlock, (3, 4, 6, 3)),
          'resnet50': (Bottleneck, (3, 4, 6, 3)),
          'resnet101': (Bottleneck, (3, 4, 23, 3)),
          'resnet152': (Bottleneck, (3, 8, 36, 3))}


class ResNet(nn.Module):
    """Torchvision ResNet. ``output_layer`` k in 1..4 cuts it after layer k
    (-> the map [N, C, H/2^(k+1), W/2^(k+1)], C = 64 * 2^(k-1) times the
    block's expansion); None keeps all four layers, then the spatial mean
    and ``fc`` (-> [N, num_classes])."""

    def __init__(self, arch: str = 'resnet34',
                 output_layer: Optional[int] = 1, in_channels: int = 1,
                 num_classes: int = 1000):
        super().__init__()
        if arch not in _ARCHS:
            raise ValueError(f'unknown resnet {arch!r}')
        if output_layer not in (None, 1, 2, 3, 4):
            raise ValueError(f'output_layer {output_layer!r} not in 1..4')
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(64)
        block, stages = _ARCHS[arch]
        features, cin = 64, 64
        depth = 4 if output_layer is None else output_layer
        for stage, blocks in enumerate(stages[:depth]):
            layer = []
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                layer.append(block(cin, features, stride))
                cin = features * block.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*layer))
            features *= 2
        self.depth = depth
        self.fc = (Linear(cin, num_classes) if output_layer is None
                   else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x))))
        for k in range(1, self.depth + 1):
            x = getattr(self, f'layer{k}')(x)
        if self.fc is None:
            return x
        return self.fc(x.mean(dim=(2, 3)))

