"""Torchvision ResNet weights into the port's modules (the port's own copy
of the rules in ``bihome_tpu/models/torch_port.py:25-186``, mapped
straight into the port's state-dict layout).

Used by the train entry point for the local ``.pth`` files the config
names (the reference downloads ImageNet weights; no file is fetched):
MODEL.BACKBONE.PRETRAINED_RESNET_PATH into the Rethinking encoder
(:func:`port_rethinking_encoder`) or the ResNet34 / ContentAware
regressor, a torchvision MODEL.HEAD.AUXILIARY_RESNET_PATH into the
frozen extractor and MODEL.HEAD.SCORE_CNN_PATH into the DSAC score CNN
(:func:`port_torchvision_resnet`). :func:`graft` loads the result,
shape-checked, into the module. :func:`load_reference_checkpoint` reads
a reference training checkpoint into the whole model (the backbone and
the head's parts, ``torch_port.py:385-445``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

# torchvision block field -> Rethinking block field (ref:
# src/backbones/Rethinking.py:158-282; the branch indices of
# ``models/weights.py``'s block maps, the same in both flavours).
_RETHINKING_BLOCK_FIELDS = {
    'conv1': 'upper_branch.0', 'bn1': 'upper_branch.1',
    'conv2': 'upper_branch.3', 'bn2': 'upper_branch.4',
    'conv3': 'upper_branch.6', 'bn3': 'upper_branch.7',
    'downsample.0': 'lower_branch.0', 'downsample.1': 'lower_branch.1',
}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (unwrapping ``{'state_dict': ...}`` and a
    training checkpoint's ``{'model': ...}``), on the CPU."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(state, dict) and 'state_dict' in state:
        state = state['state_dict']
    if isinstance(state, dict) and 'model' in state and not any(
            k.endswith('.weight') for k in state):
        state = state['model']
    return {k: v.detach() for k, v in state.items()}


def port_torchvision_resnet(state_dict: Mapping[str, torch.Tensor],
                            num_input_channels: Optional[int] = None,
                            include_fc: bool = True,
                            sum_rgb_stem: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """A torchvision resnet state dict for :class:`models.resnet.ResNet`
    (whose keys are torchvision's), without ``num_batches_tracked``.

    ``num_input_channels`` other than None or 3 drops the stem conv (the
    reference replaces conv1 by a fresh 2-channel one, ref:
    src/backbones/ResNet34.py:17). ``sum_rgb_stem`` sums the stem kernel
    over its RGB input channels -> a 1-channel stem, exactly the
    reference's grayscale repeated to 3 channels (PerceptualHead.py:
    56-60). ``include_fc`` False drops ``fc``."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith('num_batches_tracked'):
            continue
        top = key.split('.')[0]
        if top == 'conv1':
            if num_input_channels not in (None, 3) and not sum_rgb_stem:
                continue
            if sum_rgb_stem:
                val = val.sum(dim=1, keepdim=True)
        elif top == 'fc' and not include_fc:
            continue
        elif top not in ('bn1', 'fc') and not top.startswith('layer'):
            continue
        out[key] = val
    return out


def port_rethinking_encoder(state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """torchvision resnet ``layer{1,2,3}`` -> Rethinking ``layer{2,3,4}``
    (ref: src/backbones/Rethinking.py:158-282): ``layerK.B.convN`` /
    ``bnN`` -> ``layer{K+1}.B.upper_branch.*``, ``downsample.{0,1}`` ->
    ``lower_branch.{0,1}``. The stem, ``layer4`` and ``fc`` are not
    used."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith('num_batches_tracked'):
            continue
        parts = key.split('.')
        if not parts[0].startswith('layer') or int(parts[0][5:]) > 3:
            continue
        field = '.'.join(parts[2:4] if parts[2] == 'downsample'
                         else parts[2:3])
        tail = parts[4:] if parts[2] == 'downsample' else parts[3:]
        target = _RETHINKING_BLOCK_FIELDS.get(field)
        if target is not None:
            stage = f'layer{int(parts[0][5:]) + 1}'
            out['.'.join([stage, parts[1], target, *tail])] = val
    return out


def graft(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> int:
    """Copy every tensor of ``state_dict`` whose key ``module`` has into
    it; keys it lacks (a truncated extractor's deeper layers) are left
    out. Raises ValueError on a shape mismatch, as the JAX package's
    ``torch_port.graft`` does. Returns the number of tensors copied."""
    own = module.state_dict()
    copied = 0
    with torch.no_grad():
        for key, val in state_dict.items():
            if key not in own:
                continue
            if tuple(own[key].shape) != tuple(val.shape):
                raise ValueError(f'shape mismatch at {key}: '
                                 f'{tuple(own[key].shape)} vs '
                                 f'{tuple(val.shape)}')
            own[key].copy_(val)
            copied += 1
    return copied


def port_homography_net(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A reference HomographyNet state dict (``layerK = Seq(Conv, ReLU, BN
    [, MaxPool])``, ``fc1.0``, ``fc2``; ref: src/backbones/HomographyNet.py)
    for :class:`models.backbones.HomographyNetBackbone`: the same keys,
    the fc1 kernel's columns permuted from the reference's CHW flattening
    of the 16x16x128 map to the HWC one the port reads
    (``torch_port.port_homography_net``, ``:335-368``)."""
    out = {}
    for key, val in state_dict.items():
        if key.endswith('num_batches_tracked'):
            continue
        if key == 'fc1.0.weight':
            val = val.reshape(val.shape[0], 128, 16, 16).permute(
                0, 2, 3, 1).reshape(val.shape[0], -1)
        out[key] = val
    return out


def _with_prefix(state: Mapping[str, torch.Tensor], prefix: str
                 ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def load_reference_checkpoint(model: nn.Module,
                              state: Mapping[str, torch.Tensor],
                              backbone_name: str) -> List[str]:
    """Load a reference checkpoint of ``nn.Sequential(backbone, head)``
    (keys '0.*' and '1.*'; a bare backbone state dict is taken as '0.*')
    into an assembled model, as ``torch_port.port_reference_checkpoint``
    does (``:385-445``): the backbone strictly (HomographyNet through
    :func:`port_homography_net`), then the PerceptualHead's parts that
    the file holds, each grafted shape-checked: the extractor
    ('1.resnet.', torchvision layout, its RGB stem summed where the
    port's extractor takes one channel), the projection head
    ('1.projection_head.', Linear layers at even indices) and the DSAC
    score CNN ('1.dsac.score_cnn.resnet18.', with its 2-channel stem and
    1-unit fc). Returns the parts loaded."""
    from bihome_torch.models import weights

    if not any(k.startswith(('0.', '1.')) for k in state):
        state = {f'0.{k}': v for k, v in state.items()}
    backbone = _with_prefix(state, '0.')
    if backbone_name == 'HomographyNet':
        backbone = port_homography_net(backbone)
    weights.load_state_dict(model.backbone, backbone)
    loaded = ['backbone']
    parts = (('1.resnet.', 'auxiliary_resnet'),
             ('1.projection_head.', 'projection_head'),
             ('1.dsac.score_cnn.resnet18.', 'score_cnn'))
    for prefix, name in parts:
        module = getattr(model, name, None)
        sub = _with_prefix(state, prefix)
        if module is None or not sub:
            continue
        if name == 'auxiliary_resnet':
            sub = port_torchvision_resnet(
                sub, include_fc=False,
                sum_rgb_stem=module.conv1.weight.shape[1] == 1)
        elif name == 'score_cnn':
            sub = port_torchvision_resnet(sub)
        graft(module, sub)
        loaded.append(name)
    return loaded
