"""Weights between the JAX package's flax tree and the port's state dict.

``state_dict_from_jax`` is the inverse of
``bihome_tpu/models/torch_port.py:port_rethinking_full`` (both flavours;
layout rules at ``torch_port.py:53-61``), for the ResNet34Backbone of
``torch_port.py:72-127,404-408`` and for the ContentAwareBackbone of
``port_content_aware`` (``:309-332``), for the HomographyNetBackbone of
``port_homography_net`` (``:335-368``) and for the DSAC score CNN
(``:440-443``), and :func:`block_state_dict` for one block of the
library (``_BLOCK_MAPS``, ``:194-222``): conv kernels HWIO -> OIHW,
ConvTranspose kernels (kh,kw,out,in) -> (in,out,kh,kw), Dense kernels
transposed, BN scale/bias/mean/var -> weight/bias/running_mean/
running_var. The port keeps its own copy of the block maps, since the
JAX package cannot be imported without JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from bihome_torch.utils import aux_store

# flax name -> (index in the reference block's branch, kind), per block
# type (ref: src/backbones/utils.py:4-152).
_R34 = {'upper_conv1': ('upper_branch.0', 'conv'),
        'upper_bn1': ('upper_branch.1', 'bn'),
        'upper_conv2': ('upper_branch.3', 'conv'),
        'upper_bn2': ('upper_branch.4', 'bn'),
        'lower_conv': ('lower_branch.0', 'conv'),
        'lower_bn': ('lower_branch.1', 'bn')}
_R50 = {'upper_conv1': ('upper_branch.0', 'conv'),
        'upper_bn1': ('upper_branch.1', 'bn'),
        'upper_conv2': ('upper_branch.3', 'conv'),
        'upper_bn2': ('upper_branch.4', 'bn'),
        'upper_conv3': ('upper_branch.6', 'conv'),
        'upper_bn3': ('upper_branch.7', 'bn'),
        'lower_conv': ('lower_branch.0', 'conv'),
        'lower_bn': ('lower_branch.1', 'bn')}
_DECONV50 = {'upper_deconv': ('upper_branch.0', 'ct'),
             'upper_conv1': ('upper_branch.1', 'conv'),
             'upper_bn1': ('upper_branch.2', 'bn'),
             'upper_conv2': ('upper_branch.4', 'conv'),
             'upper_bn2': ('upper_branch.5', 'bn'),
             'lower_deconv': ('lower_branch.0', 'ct'),
             'lower_bn': ('lower_branch.1', 'bn')}
_DECONV34 = {'upper_deconv': ('upper_branch.0', 'ct'),
             'upper_conv1': ('upper_branch.1', 'conv'),
             'upper_bn1': ('upper_branch.2', 'bn'),
             'lower_deconv': ('lower_branch.0', 'ct'),
             'lower_bn': ('lower_branch.1', 'bn')}
# Sequential index of each stage's deconv block (ResNet34 flavour).
_DECONV_INDEX = {'layer4': 6, 'layer5': 3, 'layer6': 2, 'layer7': 1}
_BN_FIELDS = {'scale': 'weight', 'bias': 'bias'}
_BN_STATS = {'mean': 'running_mean', 'var': 'running_var'}
_HEAD = {'conv1_kernel': '0.weight', 'conv1_bias': '0.bias',
         'bn_scale': '1.weight', 'bn_bias': '1.bias',
         'conv2_kernel': '3.weight', 'conv2_bias': '3.bias'}
_HEAD_STATS = {'bn_mean': '1.running_mean', 'bn_var': '1.running_var'}


def _kernel(val: np.ndarray) -> np.ndarray:
    # HWIO -> OIHW for convs; (kh,kw,out,in) -> (in,out,kh,kw) for
    # ConvTranspose: the same permutation.
    return np.ascontiguousarray(np.transpose(val, (3, 2, 0, 1)))


def _block(block: str, r50: bool):
    """flax block name ('layer3_1', 'layer4_deconv') -> (state-dict prefix,
    field map); ``r50`` for the ResNet50 flavour's bottleneck blocks."""
    stage, idx = block.split('_')
    if idx == 'deconv':
        return f'{stage}.{_DECONV_INDEX[stage]}', _DECONV50
    return f'{stage}.{idx}', _R50 if r50 else _R34


def block_state_dict(variables: Mapping, fields: Mapping
                     ) -> Dict[str, torch.Tensor]:
    """One flax block's ``{'params', 'batch_stats'}`` tree -> the port
    block's state dict, by the block map ``fields`` (``_R34``, ``_R50``,
    ``_DECONV50``, ``_DECONV34``: flax name -> (branch index, kind))."""
    out: Dict[str, np.ndarray] = {}
    for name, (path, kind) in fields.items():
        for k, v in variables['params'][name].items():
            if kind == 'bn':
                out[f'{path}.{_BN_FIELDS[k]}'] = v
            else:
                out[f'{path}.{"weight" if k == "kernel" else k}'] = (
                    _kernel(v) if k == 'kernel' else v)
        if kind == 'bn':
            for k, v in variables['batch_stats'][name].items():
                out[f'{path}.{_BN_STATS[k]}'] = v
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _conv_bn_layers(prefix: str, variables: Mapping) -> Dict[str, np.ndarray]:
    """A ContentAware mask predictor's or feature extractor's flax
    ``convK``/``bnK`` -> ``{prefix}.layerK.0.weight`` and ``.1.*``."""
    out: Dict[str, np.ndarray] = {}
    for coll, names in (('params', _BN_FIELDS), ('batch_stats', _BN_STATS)):
        for name, leaf in variables.get(coll, {}).get(prefix, {}).items():
            k = name[-1]
            if name.startswith('conv'):
                out[f'{prefix}.layer{k}.0.weight'] = _kernel(leaf['kernel'])
            else:
                for field, v in leaf.items():
                    out[f'{prefix}.layer{k}.1.{names[field]}'] = v
    return out


def _homography_net(variables: Mapping) -> Dict[str, np.ndarray]:
    """A HomographyNetBackbone tree (``convK``/``bnK``, ``fc1``, ``fc2``)
    -> ``layerK.0.*`` (conv), ``layerK.2.*`` (BN), ``fc1.0.*``, ``fc2.*``.
    The fc1 kernel stays in flax's NHWC-flattened order, which the port's
    module reads."""
    out: Dict[str, np.ndarray] = {}
    for name, leaves in variables.get('params', {}).items():
        if name.startswith('fc'):
            key = 'fc1.0' if name == 'fc1' else name
            out[f'{key}.weight'] = np.ascontiguousarray(
                np.asarray(leaves['kernel']).T)
            out[f'{key}.bias'] = leaves['bias']
        elif name.startswith('conv'):
            out[f'layer{name[4:]}.0.weight'] = _kernel(leaves['kernel'])
            out[f'layer{name[4:]}.0.bias'] = leaves['bias']
        else:
            for k, v in leaves.items():
                out[f'layer{name[2:]}.2.{_BN_FIELDS[k]}'] = v
    for name, leaves in variables.get('batch_stats', {}).items():
        for k, v in leaves.items():
            out[f'layer{name[2:]}.2.{_BN_STATS[k]}'] = v
    return out


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` tree of numpy arrays -> port
    state dict (every key but ``num_batches_tracked``).

    Takes a RethinkingBackbone tree of either flavour (-> the backbone's
    keys, including the PF head's running statistics), a ResNet34Backbone
    tree (top level ``resnet34`` -> the reference's ``resnet34.*`` keys), a
    ContentAwareBackbone tree (``mask_predictor``, absent under FIX_MASK,
    ``feature_extractor`` and ``resnet34``), a HomographyNetBackbone tree
    (``convK``, ``bnK``, ``fc1``, ``fc2`` at the top) or a whole
    AssembledModel train state, whose top
    level holds ``backbone`` and, for the PerceptualHead,
    ``auxiliary_resnet``, any ``projection_{i}`` and the DSAC
    ``score_cnn`` (-> ``backbone.*``, ``auxiliary_resnet.*``,
    ``projection_head.{2i}.*`` and ``score_cnn.*``; every ResNet mapped by
    ``utils/aux_store``)."""
    top = {**variables['params'], **variables.get('batch_stats', {})}
    if 'resnet34' in top:
        tree = {c: variables.get(c, {}).get('resnet34', {})
                for c in ('params', 'batch_stats')}
        state, _ = aux_store.state_dict_from_aux(tree, output_layer=4)
        out_r = {f'resnet34.{k}': v for k, v in state.items()}
        for prefix in ('mask_predictor', 'feature_extractor'):
            out_r.update({k: torch.from_numpy(np.array(v, dtype=np.float32))
                          for k, v in _conv_bn_layers(prefix,
                                                      variables).items()})
        return out_r
    if 'backbone' in variables['params']:
        def sub(name):
            return {c: variables.get(c, {}).get(name, {})
                    for c in ('params', 'batch_stats')}
        out_t = {f'backbone.{k}': v
                 for k, v in state_dict_from_jax(sub('backbone')).items()}
        for name in ('auxiliary_resnet', 'score_cnn'):
            if name in variables['params']:
                state, _ = aux_store.state_dict_from_aux(sub(name),
                                                         output_layer=4)
                out_t.update({f'{name}.{k}': v for k, v in state.items()})
        # WITH_PROJECTION_HEAD's Dense layers: Linear i at index 2i, a ReLU
        # between two (bihome_tpu/models/torch_port.py:426-435).
        for name, leaves in variables['params'].items():
            if name.startswith('projection_'):
                i = 2 * int(name[len('projection_'):])
                out_t[f'projection_head.{i}.weight'] = torch.from_numpy(
                    np.ascontiguousarray(np.array(leaves['kernel'],
                                                  np.float32).T))
                out_t[f'projection_head.{i}.bias'] = torch.from_numpy(
                    np.array(leaves['bias'], np.float32))
        return out_t
    if any(re.fullmatch(r'(conv|bn|fc)\d+', name)
           for c in ('params', 'batch_stats')
           for name in variables.get(c, {})):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in _homography_net(variables).items()}
    out: Dict[str, np.ndarray] = {}
    r50 = any('upper_bn3' in leaves for c in ('params', 'batch_stats')
              for leaves in variables.get(c, {}).values())
    for block, leaves in variables['params'].items():
        if block == 'layer1_conv':
            out['layer1.0.weight'] = _kernel(leaves['kernel'])
        elif block == 'layer1_bn':
            for k, v in leaves.items():
                out[f'layer1.1.{_BN_FIELDS[k]}'] = v
        elif block == 'layer8':
            for k, v in leaves.items():
                out[f'layer8.{_HEAD[k]}'] = (
                    _kernel(v) if k.endswith('kernel') else v)
        else:
            prefix, fields = _block(block, r50)
            for name, leaf in leaves.items():
                path, kind = fields[name]
                for k, v in leaf.items():
                    if kind == 'bn':
                        out[f'{prefix}.{path}.{_BN_FIELDS[k]}'] = v
                    elif k == 'kernel':
                        out[f'{prefix}.{path}.weight'] = _kernel(v)
                    else:
                        out[f'{prefix}.{path}.bias'] = v
    for block, leaves in variables.get('batch_stats', {}).items():
        if block == 'layer1_bn':
            for k, v in leaves.items():
                out[f'layer1.1.{_BN_STATS[k]}'] = v
        elif block == 'layer8':
            for k, v in leaves.items():
                out[f'layer8.{_HEAD_STATS[k]}'] = v
        else:
            prefix, fields = _block(block, r50)
            for name, leaf in leaves.items():
                for k, v in leaf.items():
                    out[f'{prefix}.{fields[name][0]}.{_BN_STATS[k]}'] = v
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def load_state_dict(module: nn.Module,
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load ``state_dict`` into ``module``; every key must match except the
    BN ``num_batches_tracked`` counters, which eval does not read."""
    missing, unexpected = module.load_state_dict(dict(state_dict),
                                                 strict=False)
    missing = [k for k in missing if not k.endswith('num_batches_tracked')]
    if missing or unexpected:
        raise KeyError(f'state dict mismatch: missing {missing}, '
                       f'unexpected {unexpected}')
