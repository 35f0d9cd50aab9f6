"""The backbones (counterpart of ``bihome_tpu/models/backbones.py``), in
eval and training mode. Every BatchNorm has flax's training semantics
(:mod:`benchmark.reference.models.norm`). Each takes the batch dict (NHWC
patches); inside they run NCHW.

* ``RethinkingBackbone`` (``:30-101,139-233``), ResNet34 or ResNet50
  flavour, with its PF head (``PFHead(16, 128)`` or ``PFHead(64, 512)``):
  NHWC perspective fields. State-dict keys are the reference's
  (``layer1.0`` stem conv, ``layer1.1`` its BN, ``layerK.i.upper_branch.j``,
  ``layer8.{0,1,3}`` the PF head).
* ``ResNet34Backbone`` (``:109-136``), the DeTone-style regressor:
  corner deltas [B,4,2]. Keys ``resnet34.*`` (torchvision's).
* ``ContentAwareBackbone`` (``:236-336``), Zhang et al.'s: a mask
  predictor and a feature extractor per patch, the ResNet34 regressor on
  the masked features. Keys ``mask_predictor.layerK.{0,1}``,
  ``feature_extractor.layerK.{0,1}`` and ``resnet34.*``, the reference's.
* ``HomographyNetBackbone`` (``:339-370``), DeTone et al.'s VGG-style
  regressor: corner deltas [B,4,2]. Keys ``layerK.{0,2}`` (conv, BN),
  ``fc1.0`` and ``fc2``, the reference's (as ``torch_port.
  port_homography_net`` reads them); ``fc1`` reads the last map
  flattened in NHWC order, as flax's does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from benchmark.reference.models import blocks
from benchmark.reference.models.layers import Conv2d, Linear, cast
from benchmark.reference.models.norm import BatchNorm2d
from benchmark.reference.models.resnet import ResNet
from benchmark.reference.ops.pool import max_pool_2x2_s2, max_pool_3x3_s2


class PFHead(nn.Sequential):
    """Stage-8 perspective-field head: 1x1 conv -> BN -> ReLU -> 1x1 conv
    (ref: src/backbones/Rethinking.py:140-149), as four plain layers: the
    middle [N,Cmid,H,W] formed, training-mode BN on the batch statistics
    with a biased running variance (:class:`BatchNorm2d`)."""

    compute_dtype = None

    def __init__(self, in_channels: int, mid: int, out: int = 2):
        super().__init__(Conv2d(in_channels, mid, 1), BatchNorm2d(mid),
                         nn.ReLU(), Conv2d(mid, out, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(cast(x, self.compute_dtype))


class _PairBackbone(nn.Module):
    """The batch-dict interface both backbones share: the two patches
    (NHWC) concatenated on the channel axis, one forward of
    :meth:`_forward` on NCHW, one output per direction. DoubleLine stacks
    ``[cat(p1,p2); cat(p2,p1)]`` on the batch axis and runs one [2B]
    forward, as the JAX modules do (so in training mode the batch
    statistics cover both directions)."""

    def __init__(self, patch_keys: Sequence[str], target_keys: Sequence[str],
                 variant: str):
        super().__init__()
        self.patch_keys = tuple(patch_keys)
        self.target_keys = tuple(target_keys)
        self.variant = variant

    def forward(self, data: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        p1 = data[self.patch_keys[0]]
        p2 = data[self.patch_keys[1]]
        x = torch.cat([p1, p2], dim=-1)                            # NHWC
        if self.variant == 'doubleline':
            x = torch.cat([x, torch.cat([p2, p1], dim=-1)], dim=0)
        out = self._forward(x.permute(0, 3, 1, 2).contiguous())
        if self.variant == 'doubleline':
            b = p1.shape[0]
            return {self.target_keys[0]: out[:b],
                    self.target_keys[1]: out[b:]}
        return {self.target_keys[0]: out}


class RethinkingBackbone(_PairBackbone):
    """'Rethinking' (Zeng et al.) encoder/decoder producing a dense
    2-channel perspective field at patch resolution, NHWC
    (ref: src/backbones/Rethinking.py:27-149). ``resnet_block`` picks the
    flavour: ResNet34 (basic blocks, 256 channels deepest, head Cin 16 /
    Cmid 128) or ResNet50 (bottleneck blocks, 1024 channels deepest, head
    Cin 64 / Cmid 512). Both use the ResNet50-flavour deconv blocks."""

    def __init__(self, patch_keys: Sequence[str] = ('patch_1', 'patch_2'),
                 target_keys: Sequence[str] = ('pf_hat_12',),
                 variant: str = 'oneline', resnet_block: str = 'ResNet34'):
        super().__init__(patch_keys, target_keys, variant)
        self.resnet_block = resnet_block
        deconv = blocks.ResNet50DeconvBlock
        if resnet_block == 'ResNet50':
            conv, ident = blocks.ResNet50ConvBlock, blocks.ResNet50IdentityBlock
            widths, head = (256, 512, 1024), (64, 512)
        elif resnet_block == 'ResNet34':
            conv, ident = blocks.ResNet34ConvBlock, blocks.ResNet34IdentityBlock
            widths, head = (64, 128, 256), (16, 128)
        else:
            raise ValueError(f'not ported yet: Rethinking {resnet_block} '
                             'flavour')
        w2, w3, w4 = widths
        self.layer1 = nn.Sequential(
            Conv2d(2, 64, 7, stride=2, padding=3, bias=False),
            BatchNorm2d(64), nn.ReLU())
        self.layer2 = nn.Sequential(conv(64, w2, 1), ident(w2), ident(w2))
        self.layer3 = nn.Sequential(conv(w2, w3, 2),
                                    *[ident(w3) for _ in range(3)])
        self.layer4 = nn.Sequential(conv(w3, w4, 2),
                                    *[ident(w4) for _ in range(5)],
                                    deconv(w4))
        self.layer5 = nn.Sequential(*[ident(w4 // 2) for _ in range(3)],
                                    deconv(w4 // 2))
        self.layer6 = nn.Sequential(*[ident(w4 // 4) for _ in range(2)],
                                    deconv(w4 // 4))
        self.layer7 = nn.Sequential(ident(w4 // 8), deconv(w4 // 8))
        self.layer8 = PFHead(*head, 2)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(self.layer1(x))
        for layer in (self.layer2, self.layer3, self.layer4, self.layer5,
                      self.layer6, self.layer7, self.layer8):
            x = layer(x)
        return x.permute(0, 2, 3, 1)                               # NHWC


class ResNet34Backbone(_PairBackbone):
    """'ResNet34', the DeTone-style regression backbone
    (ref: src/backbones/ResNet34.py): torchvision resnet34 with a 2-channel
    stem and an 8-unit ``fc`` reshaped to corner deltas [B,4,2]."""

    def __init__(self, patch_keys: Sequence[str] = ('patch_1', 'patch_2'),
                 target_keys: Sequence[str] = ('delta_hat_12',),
                 variant: str = 'oneline'):
        super().__init__(patch_keys, target_keys, variant)
        self.resnet34 = ResNet('resnet34', output_layer=None, in_channels=2,
                               num_classes=8)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet34(x).reshape(-1, 4, 2)


def _conv_bn(cin: int, cout: int) -> nn.Sequential:
    """The reference's ``layerK``: a 3x3 conv and its BN."""
    return nn.Sequential(Conv2d(cin, cout, 3, padding=1, bias=False),
                         BatchNorm2d(cout))


class MaskPredictor(nn.Module):
    """Five 3x3 conv + BN layers on a grayscale patch (4, 8, 16, 32, 1
    channels; ReLU between, a sigmoid last), optionally normalised by each
    sample's maximum times ``normalization_strength`` and clipped to [0, 1]
    (ref: src/backbones/ContentAware.py:6-52). With ``fix_mask`` it has no
    layers and returns ones, as the JAX module does."""

    def __init__(self, fix_mask: bool = False,
                 normalization_strength: float = -1.0):
        super().__init__()
        self.fix_mask = fix_mask
        self.normalization_strength = normalization_strength
        if not fix_mask:
            for i, (cin, cout) in enumerate(zip((1, 4, 8, 16, 32),
                                                (4, 8, 16, 32, 1))):
                self.add_module(f'layer{i + 1}', _conv_bn(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fix_mask:
            return torch.ones_like(x)
        out = x
        for i in range(1, 6):
            out = getattr(self, f'layer{i}')(out)
            out = torch.sigmoid(out) if i == 5 else torch.relu(out)
        if self.normalization_strength > 0:
            peak = out.reshape(out.shape[0], -1).amax(1)
            out = out / (peak.reshape(-1, 1, 1, 1)
                         * self.normalization_strength)
            out = out.clamp(0.0, 1.0)
        return out


class FeatureExtractor(nn.Sequential):
    """Three 3x3 conv + BN + ReLU layers (4, 8, 1 channels) on a grayscale
    patch (ref: src/backbones/ContentAware.py:55-80)."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(zip((1, 4, 8), (4, 8, 1))):
            self.add_module(f'layer{i + 1}', _conv_bn(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = torch.relu(layer(x))
        return x


class ContentAwareBackbone(nn.Module):
    """'ContentAware', Zhang et al.'s CA-UDHN
    (ref: src/backbones/ContentAware.py:83-193): the mask predictor and the
    feature extractor run once on both patches stacked [2B]; the ResNet34
    regressor takes the masked features of the pair on the channel axis
    (DoubleLine stacks both orders, [2B]) -> corner deltas [B,4,2]. Also
    returns the masks and features (NHWC) under MASK_KEYS and
    FEATURE_KEYS. :meth:`extract_features` re-runs the extractor, for the
    TripletHead's warped patches; in training mode each run updates the
    extractor's BN running statistics, as the flax module does."""

    def __init__(self, patch_keys: Sequence[str] = ('patch_1', 'patch_2'),
                 mask_keys: Sequence[str] = ('mask_1', 'mask_2'),
                 feature_keys: Sequence[str] = ('feature_1', 'feature_2'),
                 target_keys: Sequence[str] = ('delta_hat_12',),
                 variant: str = 'doubleline', fix_mask: bool = False,
                 mask_normalization_strength: float = -1.0):
        super().__init__()
        self.patch_keys = tuple(patch_keys)
        self.mask_keys = tuple(mask_keys)
        self.feature_keys = tuple(feature_keys)
        self.target_keys = tuple(target_keys)
        self.variant = variant
        self.fix_mask = fix_mask
        self.mask_predictor = MaskPredictor(fix_mask,
                                            mask_normalization_strength)
        self.feature_extractor = FeatureExtractor()
        self.resnet34 = ResNet('resnet34', output_layer=None, in_channels=2,
                               num_classes=8)

    def forward(self, data: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        p1 = data[self.patch_keys[0]]
        p2 = data[self.patch_keys[1]]
        b = p1.shape[0]
        stacked = torch.cat([p1, p2], dim=0).permute(0, 3, 1, 2).contiguous()
        m = self.mask_predictor(stacked)
        f = self.feature_extractor(stacked)
        g = m * f
        g12 = torch.cat([g[:b], g[b:]], dim=1)
        if self.variant == 'doubleline':
            g21 = torch.cat([g[b:], g[:b]], dim=1)
            o = self.resnet34(torch.cat([g12, g21], dim=0)).reshape(-1, 4, 2)
            deltas = {self.target_keys[0]: o[:b], self.target_keys[1]: o[b:]}
        else:
            deltas = {self.target_keys[0]:
                      self.resnet34(g12).reshape(-1, 4, 2)}
        m, f = m.permute(0, 2, 3, 1), f.permute(0, 2, 3, 1)          # NHWC
        return {self.mask_keys[0]: m[:b], self.mask_keys[1]: m[b:],
                self.feature_keys[0]: f[:b], self.feature_keys[1]: f[b:],
                **deltas}

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        """The feature extractor on NHWC patches -> NHWC features."""
        nchw = x.permute(0, 3, 1, 2).contiguous()
        return self.feature_extractor(nchw).permute(0, 2, 3, 1)


class HomographyNetBackbone(nn.Module):
    """'HomographyNet', DeTone et al.'s regressor
    (``bihome_tpu/models/backbones.py:339-370``, ref:
    src/backbones/HomographyNet.py): the two patches on the channel axis,
    3x3 convs each followed by ReLU then BN (the reference's order), 2x2
    max-pools after the layers the layout marks, then ``fc1`` (1024, ReLU)
    and ``fc2`` (8) -> corner deltas [B,4,2]. IMAGE_SIZE 128 has 8 conv
    layers and 3 pools, 512 has 12 and 5: the last map is 16x16x128
    either way. One line only, as in JAX."""

    LAYOUTS = {128: ((64, False), (64, True), (64, False), (64, True),
                     (128, False), (128, True), (128, False), (128, False)),
               512: ((64, False), (64, True), (64, False), (64, True),
                     (128, False), (128, True), (128, False), (128, True),
                     (128, False), (128, True), (128, False), (128, False))}

    def __init__(self, patch_keys: Sequence[str] = ('patch_1', 'patch_2'),
                 target_keys: Sequence[str] = ('delta_hat_12',),
                 image_size: int = 128):
        super().__init__()
        if image_size not in self.LAYOUTS:
            raise ValueError(f'HomographyNet IMAGE_SIZE must be 128 or 512, '
                             f'got {image_size}')
        self.patch_keys = tuple(patch_keys)
        self.target_keys = tuple(target_keys)
        self.pools = tuple(pool for _, pool in self.LAYOUTS[image_size])
        cin = 2
        for i, (width, _) in enumerate(self.LAYOUTS[image_size]):
            self.add_module(f'layer{i + 1}', nn.Sequential(
                Conv2d(cin, width, 3, padding=1), nn.ReLU(),
                BatchNorm2d(width)))
            cin = width
        self.fc1 = nn.Sequential(Linear(16 * 16 * 128, 1024), nn.ReLU())
        self.fc2 = Linear(1024, 8)

    def forward(self, data: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        x = torch.cat([data[self.patch_keys[0]], data[self.patch_keys[1]]],
                      dim=-1).permute(0, 3, 1, 2).contiguous()
        for i, pool in enumerate(self.pools):
            x = getattr(self, f'layer{i + 1}')(x)
            if pool:
                x = max_pool_2x2_s2(x)
        # flax flattens NHWC: its fc1 kernel (and the reference's, permuted
        # by port_homography_net) reads the map in (h, w, c) order.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.fc2(self.fc1(x))
        return {self.target_keys[0]: x.reshape(-1, 4, 2)}


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: conv kernels from N(0, 2/fan_out) (the JAX package's
    ``conv_init`` scale), linear kernels from N(0, 1/fan_in) (flax
    ``Dense``'s lecun scale), biases zero, BN the identity affine with
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
            elif isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, std=m.in_features ** -0.5,
                                generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in module.modules():
            if isinstance(m, PFHead):
                m[3].weight.mul_(0.01)


def build_backbone(cfg: Dict) -> nn.Module:
    """Backbone from a reference MODEL.BACKBONE yaml section
    (``bihome_tpu/models/backbones.py:373-405``)."""
    name = cfg['NAME']
    kwargs = dict(patch_keys=tuple(cfg['PATCH_KEYS']),
                  target_keys=tuple(cfg['TARGET_KEYS']),
                  variant=str(cfg.get('VARIANT', 'OneLine')).lower())
    if name == 'ResNet34':
        return ResNet34Backbone(**kwargs)
    if name == 'Rethinking':
        return RethinkingBackbone(
            **kwargs, resnet_block=cfg.get('RESNET_BLOCK', 'ResNet34'))
    if name == 'ContentAware':
        return ContentAwareBackbone(
            **kwargs, mask_keys=tuple(cfg['MASK_KEYS']),
            feature_keys=tuple(cfg['FEATURE_KEYS']),
            fix_mask=bool(cfg.get('FIX_MASK', False)),
            mask_normalization_strength=float(
                cfg.get('MASK_NORMALIZATION_STRENGTH', -1)))
    if name == 'HomographyNet':
        return HomographyNetBackbone(
            kwargs['patch_keys'], kwargs['target_keys'],
            int(cfg.get('IMAGE_SIZE', 128)))
    raise ValueError(f'not ported yet: backbone {name!r}')
