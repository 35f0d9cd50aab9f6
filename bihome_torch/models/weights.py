"""Weights between the JAX package's flax tree and the port's state dict.

``state_dict_from_jax`` is the inverse of
``bihome_tpu/models/torch_port.py:port_rethinking_full`` (layout rules at
``torch_port.py:53-61``): conv kernels HWIO -> OIHW, ConvTranspose kernels
(kh,kw,out,in) -> (in,out,kh,kw), BN scale/bias/mean/var ->
weight/bias/running_mean/running_var. The port keeps its own copy of the
block maps, since the JAX package cannot be imported without JAX.
"""

from __future__ import annotations

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
_DECONV50 = {'upper_deconv': ('upper_branch.0', 'ct'),
             'upper_conv1': ('upper_branch.1', 'conv'),
             'upper_bn1': ('upper_branch.2', 'bn'),
             'upper_conv2': ('upper_branch.4', 'conv'),
             'upper_bn2': ('upper_branch.5', 'bn'),
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


def _block(block: str):
    """flax block name ('layer3_1', 'layer4_deconv') -> (state-dict prefix,
    field map)."""
    stage, idx = block.split('_')
    if idx == 'deconv':
        return f'{stage}.{_DECONV_INDEX[stage]}', _DECONV50
    return f'{stage}.{idx}', _R34


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` tree of numpy arrays -> port
    state dict (every key but ``num_batches_tracked``).

    Takes either a RethinkingBackbone tree (-> the backbone's keys,
    including the PF head's running statistics) or a whole AssembledModel
    train state, whose top level holds ``backbone`` and
    ``auxiliary_resnet`` (-> ``backbone.*`` and ``auxiliary_resnet.*``,
    the extractor mapped by ``utils/aux_store``)."""
    if 'backbone' in variables['params']:
        def sub(name):
            return {c: variables.get(c, {}).get(name, {})
                    for c in ('params', 'batch_stats')}
        out_t = {f'backbone.{k}': v
                 for k, v in state_dict_from_jax(sub('backbone')).items()}
        if 'auxiliary_resnet' in variables['params']:
            aux, _ = aux_store.state_dict_from_aux(sub('auxiliary_resnet'),
                                                   output_layer=4)
            out_t.update({f'auxiliary_resnet.{k}': v for k, v in aux.items()})
        return out_t
    out: Dict[str, np.ndarray] = {}
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
            prefix, fields = _block(block)
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
            prefix, fields = _block(block)
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
