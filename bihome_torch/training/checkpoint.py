"""Checkpoints of the port (counterpart of
``bihome_tpu/training/checkpoint.py``), as ``.pth`` files.

``<dir>/model_{step:06d}.pth`` holds the reference layout
``{"model": {"0.<backbone key>", "1.auxiliary_resnet.<key>", ...},
"optimizer": {"adam", "count"}, "step": N}`` (``eval --torch_ckpt`` reads
it), and beside it ``"random"``: the state of every stateful random
source of the training run (the pair and DSAC generators, the epoch
samplers, the host-prep crops), so that a resumed run goes on exactly
as the uninterrupted run would have. Only files named
``model_NNNNNN.pth`` count as checkpoints: the JAX package's Orbax step
directories and ``metrics.jsonl`` files are ignored.

* :class:`CheckPointer`: ``save``, ``latest_step`` and ``load`` (resume;
  RESTART_LEARNING_RATE; weights-only when the saved optimizer state does
  not fit), ``checkpoint.py:27-83``.
* :func:`load_pretrained_params` (MODEL.PRETRAINED, ``:121``): a partial
  copy wherever key and shape match.
* :func:`load_weights_only` (``:140``): the eval loader.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from bihome_torch.training.train_state import Optimizer

_MODEL_FILE = re.compile(r'^model_(\d{6,})\.pth$')


def _parts(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Module]]:
    """(key prefix, module) of the reference layout: the backbone under
    '0.', the PerceptualHead's extractor under '1.auxiliary_resnet.', its
    projection head under '1.projection_head.' and the DSAC score CNN
    under '1.dsac.score_cnn.resnet18.' (the reference's key)."""
    parts = [('0.', model.backbone)]
    if getattr(model, 'auxiliary_resnet', None) is not None:
        parts.append(('1.auxiliary_resnet.', model.auxiliary_resnet))
    if getattr(model, 'projection_head', None) is not None:
        parts.append(('1.projection_head.', model.projection_head))
    if getattr(model, 'score_cnn', None) is not None:
        parts.append(('1.dsac.score_cnn.resnet18.', model.score_cnn))
    return parts


def model_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's tensors in the reference layout, on the CPU."""
    return {prefix + k: v.detach().cpu() for prefix, module in _parts(model)
            for k, v in module.state_dict().items()}


def merge_matching(model: torch.nn.Module,
                   state: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """Copy each tensor of ``state`` (reference layout) into the model
    where the key exists in both and the shapes match; a key in both with
    another shape is skipped, one only in the model keeps its value.
    Returns (copied, skipped), counted as the JAX package's
    ``_merge_matching`` counts its leaves (``checkpoint.py:84-103``): BN's
    ``num_batches_tracked``, which flax has no leaf for, is copied but not
    counted."""
    copied = skipped = 0
    with torch.no_grad():
        for prefix, module in _parts(model):
            for key, dst in module.state_dict().items():
                src = state.get(prefix + key)
                if src is None:
                    continue
                counted = not key.endswith('num_batches_tracked')
                if tuple(src.shape) == tuple(dst.shape):
                    dst.copy_(src)
                    copied += counted
                else:
                    skipped += counted
    return copied, skipped


def load_model_state(model: torch.nn.Module,
                     state: Mapping[str, torch.Tensor]) -> None:
    """Strict load of the reference layout: every key of the model must be
    in ``state`` with its shape, and ``state`` must hold no other. Raises
    ValueError (and changes nothing) otherwise."""
    own = model_state_dict(model)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    shapes = [k for k in own if k in state
              and tuple(own[k].shape) != tuple(state[k].shape)]
    if missing or unexpected or shapes:
        raise ValueError(f'checkpoint does not fit the model: missing '
                         f'{missing[:3]}, unexpected {unexpected[:3]}, '
                         f'shapes differ at {shapes[:3]}')
    merge_matching(model, state)


def _checkpoint_files(directory: str) -> Dict[int, str]:
    if not os.path.isdir(directory):
        return {}
    found = {}
    for name in os.listdir(directory):
        m = _MODEL_FILE.match(name)
        if m and os.path.isfile(os.path.join(directory, name)):
            found[int(m.group(1))] = os.path.join(directory, name)
    return found


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest ``model_NNNNNN.pth`` in ``directory``, or None."""
    found = _checkpoint_files(directory)
    return found[max(found)] if found else None


def resolve_checkpoint_dir(path: str) -> str:
    """A log directory -> its newest ``model_NNNNNN.pth``; a file -> the
    file (``checkpoint.py:106``). Raises FileNotFoundError when the
    directory holds no such file or the path does not exist."""
    if os.path.isfile(path):
        return path
    latest = latest_checkpoint(path)
    if latest is None:
        raise FileNotFoundError(f'no model_NNNNNN.pth checkpoint under '
                                f'{path}')
    return latest


def _load(path: str) -> Dict[str, Any]:
    data = torch.load(path, map_location='cpu', weights_only=True)
    if not (isinstance(data, dict) and 'model' in data):
        data = {'model': data}
    return data


def _step_of(path: str, data: Mapping[str, Any]) -> int:
    m = _MODEL_FILE.match(os.path.basename(path))
    return int(m.group(1)) if m else int(data.get('step', 0))


def load_pretrained_params(path: str, model: torch.nn.Module
                           ) -> Tuple[int, int]:
    """Weights-only warm start from a port checkpoint (file or log
    directory; MODEL.PRETRAINED, ``checkpoint.py:121``): partial by design,
    e.g. a zeng-orig backbone warm-starts zeng-biHomE and leaves its
    extractor, absent from the source, alone. Returns (copied, skipped)."""
    path = resolve_checkpoint_dir(path)
    copied, skipped = merge_matching(model, _load(path)['model'])
    print(f'Pretrained: {copied} tensors loaded, {skipped} shape-skipped '
          f'from {path}')
    return copied, skipped


def load_weights_only(path: str, model: torch.nn.Module) -> int:
    """The model's tensors (and no optimizer state) from a port checkpoint
    file or log directory (``checkpoint.py:140``); keys and shapes that
    do not match keep the model's values. Returns the checkpoint's step."""
    path = resolve_checkpoint_dir(path)
    data = _load(path)
    copied, skipped = merge_matching(model, data['model'])
    if skipped:
        print(f'load_weights_only: {skipped} shape-mismatched tensors '
              f'kept from the model (loaded {copied})')
    return _step_of(path, data)


# Stateful random sources, saved beside the reference keys.
RandomSource = Any      # torch.Generator | np.random.RandomState


def random_state_dict(sources: Mapping[str, RandomSource]) -> Dict:
    """The state of each source as tensors and numbers (loadable with
    ``torch.load(weights_only=True)``); a generator that lives on a card
    is saved with its device type, ``{"device": "cuda", "state": ...}``."""
    out = {}
    for name, src in sources.items():
        if isinstance(src, torch.Generator):
            out[name] = (src.get_state() if src.device.type == 'cpu' else
                         {'device': src.device.type,
                          'state': src.get_state()})
        else:
            kind, keys, pos, has_gauss, cached = src.get_state()
            out[name] = {'keys': torch.from_numpy(keys.astype(np.int64)),
                         'pos': int(pos), 'has_gauss': int(has_gauss),
                         'cached_gaussian': float(cached)}
    return out


def load_random_state(sources: Mapping[str, RandomSource],
                      saved: Mapping[str, Any]) -> List[str]:
    """Restore each source that ``saved`` holds; returns the names of the
    sources it does not hold, or holds for a generator on another device
    type (a CPU state does not fit a card's generator, nor the reverse):
    they start from their seeds."""
    fresh = []
    for name, src in sources.items():
        if name not in saved:
            fresh.append(name)
        elif isinstance(src, torch.Generator):
            state = saved[name]
            kind = state['device'] if isinstance(state, dict) else 'cpu'
            if kind != src.device.type:
                fresh.append(name)
            else:
                src.set_state(state['state'] if isinstance(state, dict)
                              else state)
        else:
            s = saved[name]
            src.set_state(('MT19937', s['keys'].numpy().astype(np.uint32),
                           s['pos'], s['has_gauss'], s['cached_gaussian']))
    return fresh


class CheckPointer:
    """Step-named checkpoints in ``directory`` (``checkpoint.py:27``)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'model_{step:06d}.pth')

    def save(self, step: int, model: torch.nn.Module, optimizer: Optimizer,
             random_sources: Optional[Mapping[str, RandomSource]] = None,
             random_states: Optional[Mapping[str, Any]] = None) -> str:
        """Write step ``step``'s checkpoint; ``random_states`` adds states
        already in :func:`random_state_dict`'s form (other ranks')."""
        data = {'model': model_state_dict(model),
                'optimizer': optimizer.state_dict(), 'step': int(step)}
        if random_sources or random_states:
            data['random'] = random_state_dict(random_sources or {})
            data['random'].update(random_states or {})
        path = self.path(step)
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save(data, tmp)
        os.replace(tmp, path)
        return path

    def latest_step(self) -> Optional[int]:
        found = _checkpoint_files(self.directory)
        return max(found) if found else None

    def load(self, model: torch.nn.Module, optimizer: Optimizer,
             step: Optional[int] = None,
             restart_learning_rate: bool = False
             ) -> Tuple[Dict[str, Any], int]:
        """Restore the latest (or ``step``'s) checkpoint into ``model`` and
        ``optimizer``; returns (the checkpoint's dict, its step), or
        ({}, 0) when there is none. RESTART_LEARNING_RATE leaves the
        optimizer fresh (Adam's moments empty, count 0) and keeps the step
        (``checkpoint.py:80-82``). When the saved model or optimizer state
        does not fit (the trainable set changed), the weights are loaded
        where they match and the optimizer starts fresh, with one line
        printed (``:56-78``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return {}, 0
        data = _load(self.path(step))
        try:
            load_model_state(model, data['model'])
            if not restart_learning_rate:
                optimizer.load_state_dict(data['optimizer'])
        except ValueError:
            print(f'CheckPointer: the state of step {step} does not fit the '
                  'current model and trainable set; resuming weights-only '
                  'with a fresh optimizer state.')
            merge_matching(model, data['model'])
        return data, int(step)
