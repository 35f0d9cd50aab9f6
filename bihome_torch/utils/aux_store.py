"""The auxiliary-extractor weights (``aux_*.npz``) for the port.

The port's own copy of ``bihome_tpu/utils/aux_store.py`` (the JAX package
cannot be imported without JAX). The file holds flat flax paths,
``params/<module>/<leaf>`` and ``batch_stats/<module>/<leaf>``, for
conv1/bn1/layer1 (and layer2 when the extractor was trained deeper); conv
kernels are HWIO, with I = 1 for the summed grayscale stem.
:func:`state_dict_from_aux` prunes to the model's truncation depth and maps
the tree onto :class:`bihome_torch.models.resnet.ResNet`'s torchvision
keys; :func:`save_aux_npz`, its inverse, writes such a file from the
port's state dict (``bihome_torch.pretrain_aux`` saves with it), which
the JAX package's ``load_aux_npz`` reads.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax leaf -> torchvision name, per collection.
_BN_PARAMS = {'scale': 'weight', 'bias': 'bias'}
_BN_STATS = {'mean': 'running_mean', 'var': 'running_var'}
# flax submodule of a block -> torchvision submodule.
_BLOCK_MODULES = {'conv1': 'conv1', 'bn1': 'bn1', 'conv2': 'conv2',
                  'bn2': 'bn2', 'conv3': 'conv3', 'bn3': 'bn3',
                  'downsample_conv': 'downsample.0',
                  'downsample_bn': 'downsample.1'}
# The flax top-level modules a file keeps (``aux_store.py:18``): all that
# the PerceptualHead reads at AUXILIARY_RESNET_OUTPUT_LAYER <= 2.
_KEEP_PREFIXES = ('conv1', 'bn1', 'layer1_', 'layer2_')


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        parts = path.split('/')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_aux_npz(path: str) -> Dict[str, Dict]:
    """-> {'params': subtree, 'batch_stats': subtree}, flax layout."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    tree = _unflatten(flat)
    return {'params': tree.get('params', {}),
            'batch_stats': tree.get('batch_stats', {})}


def _torch_name(module: str) -> str:
    """flax module path ('conv1', 'layer1_0/conv2') -> torchvision name."""
    if '/' not in module:
        return module
    block, sub = module.split('/', 1)
    stage, idx = block.split('_')
    return f'{stage}.{idx}.{_BLOCK_MODULES[sub]}'


def state_dict_from_aux(variables: Mapping, output_layer: int
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """flax ResNet tree {'params', 'batch_stats'} (numpy) -> (ResNet state
    dict without ``num_batches_tracked``, sorted list of the flax top-level
    modules dropped because they lie beyond ``output_layer``). An ``fc``
    (the untruncated ResNet's) maps to ``fc.weight``/``fc.bias``."""
    out: Dict[str, np.ndarray] = {}
    dropped = set()

    def walk(tree: Mapping, path: str, collection: str) -> None:
        for k, v in tree.items():
            here = f'{path}/{k}' if path else k
            if isinstance(v, Mapping):
                walk(v, here, collection)
                continue
            module = path
            top = module.split('/')[0]
            if top.startswith('layer') and int(top[5]) > output_layer:
                dropped.add(top)
                continue
            name = _torch_name(module)
            if collection == 'batch_stats':
                out[f'{name}.{_BN_STATS[k]}'] = v
            elif k == 'kernel':
                # HWIO -> OIHW; a Dense kernel [in, out] -> Linear [out, in].
                out[f'{name}.weight'] = (np.transpose(v, (3, 2, 0, 1))
                                         if v.ndim == 4 else v.T)
            else:
                out[f'{name}.{_BN_PARAMS[k]}'] = v

    for collection in ('params', 'batch_stats'):
        walk(variables.get(collection, {}), '', collection)
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32, order='C'))
             for k, v in out.items()}
    return state, sorted(dropped)


def _flax_name(module: str) -> str:
    """torchvision module name ('conv1', 'layer1.0.downsample.0') -> flax
    module path ('conv1', 'layer1_0/downsample_conv')."""
    parts = module.split('.')
    if len(parts) == 1:
        return module
    flax = {v: k for k, v in _BLOCK_MODULES.items()}
    return f'{parts[0]}_{parts[1]}/{flax[".".join(parts[2:])]}'


def save_aux_npz(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """Write a :class:`~bihome_torch.models.resnet.ResNet` state dict as
    the flat flax ``.npz`` of ``bihome_tpu/utils/aux_store.py:43-49``:
    conv weights OIHW -> HWIO ``kernel``, BN weight/bias -> ``scale`` /
    ``bias`` under ``params``, running mean/var -> ``mean`` / ``var``
    under ``batch_stats``, float32, only the modules of
    ``_KEEP_PREFIXES`` (no ``fc``, no layer3/4, no BN counters)."""
    leaves = {'weight': ('params', 'kernel'), 'bias': ('params', 'bias'),
              'running_mean': ('batch_stats', 'mean'),
              'running_var': ('batch_stats', 'var')}
    flat: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        module, leaf = key.rsplit('.', 1)
        if leaf not in leaves:
            continue
        name = _flax_name(module)
        if not name.startswith(_KEEP_PREFIXES):
            continue
        value = value.detach().float().cpu().numpy()
        collection, flax_leaf = leaves[leaf]
        if leaf == 'weight' and value.ndim == 4:
            value = np.transpose(value, (2, 3, 1, 0))        # OIHW -> HWIO
        elif leaf == 'weight':
            flax_leaf = 'scale'                              # a BN's weight
        flat[f'{collection}/{name}/{flax_leaf}'] = np.ascontiguousarray(
            value)
    np.savez(path, **flat)
