"""The Rethinking backbone and its PF head (counterpart of
``bihome_tpu/models/backbones.py:30-101,139-233``), in eval and training
mode. Every BatchNorm has flax's training semantics
(:mod:`bihome_torch.models.norm`).

Only the ResNet34 flavour is ported. The backbone takes the batch dict
(NHWC patches) and returns NHWC perspective fields; inside it runs NCHW.
State-dict keys are the reference's (``layer1.0`` stem conv, ``layer1.1``
its BN, ``layerK.i.upper_branch.j``, ``layer8.{0,1,3}`` the PF head).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from bihome_torch.models import blocks
from bihome_torch.models.norm import BatchNorm2d
from bihome_torch.ops import fused_head
from bihome_torch.ops.pool import max_pool_3x3_s2


class PFHead(nn.Sequential):
    """Stage-8 perspective-field head: 1x1 conv -> BN -> ReLU -> 1x1 conv
    (ref: src/backbones/Rethinking.py:140-149), computed by the fused
    kernels (:class:`bihome_torch.ops.fused_head.FusedPFHead`).

    Eval mode normalises with the running statistics. Training mode
    normalises with the batch statistics (``batch_stats_affine``, the
    middle never formed) and then moves the running statistics toward
    them with momentum 0.1 and the biased variance, as
    ``bihome_tpu/models/backbones.py:96-100`` does."""

    def __init__(self, in_channels: int, mid: int, out: int = 2):
        super().__init__(nn.Conv2d(in_channels, mid, 1), BatchNorm2d(mid),
                         nn.ReLU(), nn.Conv2d(mid, out, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, bn, _, conv2 = self
        if not self.training:
            return fused_head.FusedPFHead.apply(
                x, conv1.weight, conv1.bias, bn.weight, bn.bias,
                conv2.weight, conv2.bias, bn.running_mean, bn.running_var,
                bn.eps, False)
        with torch.no_grad():
            mean, var = fused_head.batch_stats_affine(x, conv1.weight,
                                                      conv1.bias)
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
            bn.num_batches_tracked.add_(1)
        return fused_head.FusedPFHead.apply(
            x, conv1.weight, conv1.bias, bn.weight, bn.bias, conv2.weight,
            conv2.bias, mean, var, bn.eps, True)


class RethinkingBackbone(nn.Module):
    """'Rethinking' (Zeng et al.) encoder/decoder producing a dense
    2-channel perspective field at patch resolution
    (ref: src/backbones/Rethinking.py:27-149), ResNet34 flavour.

    DoubleLine stacks ``[cat(p1,p2); cat(p2,p1)]`` on the batch axis and
    runs one [2B] forward."""

    def __init__(self, patch_keys: Sequence[str] = ('patch_1', 'patch_2'),
                 target_keys: Sequence[str] = ('pf_hat_12',),
                 variant: str = 'oneline'):
        super().__init__()
        self.patch_keys = tuple(patch_keys)
        self.target_keys = tuple(target_keys)
        self.variant = variant
        r34c, r34i = blocks.ResNet34ConvBlock, blocks.ResNet34IdentityBlock
        deconv = blocks.ResNet50DeconvBlock
        self.layer1 = nn.Sequential(
            nn.Conv2d(2, 64, 7, stride=2, padding=3, bias=False),
            BatchNorm2d(64), nn.ReLU())
        self.layer2 = nn.Sequential(r34c(64, 64, 1), r34i(64), r34i(64))
        self.layer3 = nn.Sequential(r34c(64, 128, 2),
                                    *[r34i(128) for _ in range(3)])
        self.layer4 = nn.Sequential(r34c(128, 256, 2),
                                    *[r34i(256) for _ in range(5)],
                                    deconv(256))
        self.layer5 = nn.Sequential(*[r34i(128) for _ in range(3)],
                                    deconv(128))
        self.layer6 = nn.Sequential(*[r34i(64) for _ in range(2)],
                                    deconv(64))
        self.layer7 = nn.Sequential(r34i(32), deconv(32))
        self.layer8 = PFHead(16, 128, 2)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(self.layer1(x))
        for layer in (self.layer2, self.layer3, self.layer4, self.layer5,
                      self.layer6, self.layer7, self.layer8):
            x = layer(x)
        return x

    def forward(self, data: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        p1 = data[self.patch_keys[0]]
        p2 = data[self.patch_keys[1]]
        x = torch.cat([p1, p2], dim=-1)                            # NHWC
        if self.variant == 'doubleline':
            x = torch.cat([x, torch.cat([p2, p1], dim=-1)], dim=0)
        pf = self._forward(x.permute(0, 3, 1, 2).contiguous())
        pf = pf.permute(0, 2, 3, 1)                                # NHWC
        if self.variant == 'doubleline':
            b = p1.shape[0]
            return {self.target_keys[0]: pf[:b], self.target_keys[1]: pf[b:]}
        return {self.target_keys[0]: pf}


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: conv kernels from N(0, 2/fan_out) (the JAX package's
    ``conv_init`` scale), biases zero, BN the identity affine with
    running statistics (0, 1). Each PF head's output conv is then scaled
    by 1/100: unscaled, a random backbone's field is hundreds of pixels
    and the DSAC fit is ill-conditioned; scaled, it is a few pixels, the
    size of a trained model's field and of the corner perturbations."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu',
                                        generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in module.modules():
            if isinstance(m, PFHead):
                m[3].weight.mul_(0.01)


def build_backbone(cfg: Dict) -> RethinkingBackbone:
    """Backbone from a reference MODEL.BACKBONE yaml section."""
    name = cfg['NAME']
    if name != 'Rethinking':
        raise ValueError(f'not ported yet: backbone {name!r}')
    flavour = cfg.get('RESNET_BLOCK', 'ResNet34')
    if flavour != 'ResNet34':
        raise ValueError(f'not ported yet: Rethinking {flavour} flavour')
    return RethinkingBackbone(
        patch_keys=tuple(cfg['PATCH_KEYS']),
        target_keys=tuple(cfg['TARGET_KEYS']),
        variant=str(cfg.get('VARIANT', 'OneLine')).lower())
