"""Faults planted under the timed path, for the tests and the calibration
that show the correctness check catching them; the benchmark's own runs
plant none.

* ``unchanged``: the optimizer's step returns the state unchanged;
* ``half_batch``: the second half of every synthesized batch replaced by
  the first, so the loss is taken over half of the batch;
* ``altered``: the first sample's output altered where it is produced
  (its perspective field or its corner deltas plus one pixel; a served
  call's first delta_hat plus one pixel).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

FAULTS = ('unchanged', 'half_batch', 'altered')


def _nothing() -> None:
    return None


def plant_train(fault: Optional[str], model, optimizer) -> Callable[[], None]:
    """Plant ``fault`` in one training object; returns what undoes what it
    changed outside that object."""
    if fault is None:
        return _nothing
    if fault == 'unchanged':
        optimizer.step = lambda: optimizer.schedule(optimizer.count)
        return _nothing
    if fault == 'half_batch':
        from bihome_torch.data import pipeline
        generate = pipeline.generate_pairs

        def halved(*a, **kw) -> Dict:
            batch = generate(*a, **kw)
            for key, t in batch.items():
                if isinstance(t, torch.Tensor) and t.dim() >= 1:
                    half = t.shape[0] // 2
                    batch[key] = torch.cat([t[:half], t[:t.shape[0] - half]])
            return batch
        pipeline.generate_pairs = halved
        return lambda: setattr(pipeline, 'generate_pairs', generate)
    if fault == 'altered':
        def alter(_module, _inputs, outputs):
            key = next(iter(outputs))
            out = dict(outputs)
            out[key] = out[key] + _first_row(out[key])
            return out
        model.backbone.register_forward_hook(alter)
        return _nothing
    raise ValueError(f'unknown fault {fault!r}')


def plant_call(fault: Optional[str], module) -> None:
    if fault is None:
        return
    forward = module.forward
    if fault == 'half_batch':
        def halved(p1, p2):
            half = p1.shape[0] // 2
            d = forward(p1[:half], p2[:half])
            return torch.cat([d, d[:p1.shape[0] - half]])
        module.forward = halved
    elif fault == 'altered':
        module.forward = lambda p1, p2: (lambda d: d + _first_row(d))(
            forward(p1, p2))
    else:
        raise ValueError(f'unknown fault {fault!r}')


def _first_row(t: torch.Tensor) -> torch.Tensor:
    """One pixel on every value of the first row of ``t``, 0 elsewhere."""
    bump = torch.zeros_like(t)
    bump[0] = 1.0
    return bump
