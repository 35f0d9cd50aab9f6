"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str = 'cuda') -> torch.device:
    """``torch.device`` for ``name``; entry points default to ``'cuda'``.

    Raises when CUDA is asked for but unavailable: a run meant for the
    card never quietly falls back to the CPU. Pass ``'cpu'`` explicitly
    to run the plain-torch paths.
    """
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {name!r} requested but CUDA is not available; '
            'pass --device cpu (or device="cpu") to run on the CPU')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {name!r}: use cuda or cpu')
    return device
