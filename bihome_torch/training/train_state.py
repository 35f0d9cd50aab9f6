"""Optimizer with the reference solver's semantics (counterpart of
``bihome_tpu/training/train_state.py:20-63``).

Order of one update, as the optax chain of ``make_optimizer``: clip the
trainable gradients by their global norm (when GRADIENT_CLIP > 0), add
``weight_decay * param`` to the gradient (torch Adam's L2 decay), the Adam
moments (eps 1e-8), then scale by the learning rate of the per-step
MultiStepLR: update number k (0-based) uses ``schedule(k)``, which is
``lr * decay**(number of milestones <= k)``. Frozen parameters (the
auxiliary extractor) are not given to the optimizer and never change.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Sequence

import torch


def make_lr_schedule(lr: float, milestones: Sequence[int], decay: float):
    """k -> learning rate of update k (optax.piecewise_constant_schedule
    with every milestone scaling by ``decay``)."""
    bounds = sorted(int(m) for m in milestones)

    def schedule(k: int) -> float:
        return lr * decay ** sum(1 for m in bounds if k >= m)

    return schedule


class Optimizer:
    """Adam + per-step MultiStepLR + optional global-norm clip over the
    given (trainable) parameters. ``step()`` applies update number
    ``self.count`` and returns the learning rate it used."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 milestones: Sequence[int] = (), decay: float = 0.1,
                 beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0, gradient_clip: float = -1.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = make_lr_schedule(lr, milestones, decay)
        self.gradient_clip = float(gradient_clip or -1.0)
        self.adam = torch.optim.Adam(self.params, lr=lr,
                                     betas=(beta1, beta2), eps=1e-8,
                                     weight_decay=float(weight_decay or 0.0))
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def global_norm(self) -> torch.Tensor:
        """Global L2 norm of the current gradients (0 for none)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return torch.zeros(())
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    @torch.no_grad()
    def step(self) -> float:
        if self.gradient_clip > 0:
            # optax.clip_by_global_norm: g * clip / norm when norm > clip.
            norm = self.global_norm()
            scale = torch.where(norm < self.gradient_clip,
                                torch.ones_like(norm),
                                self.gradient_clip / norm)
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group['lr'] = lr
        self.adam.step()
        self.count += 1
        return lr

    def state_dict(self) -> Dict:
        return {'adam': self.adam.state_dict(), 'count': self.count}

    def load_state_dict(self, state: Dict) -> None:
        """Restore the Adam moments and ``count`` (the MultiStepLR
        position: the next update is number ``count``). The moments land on
        each parameter's device. Raises ValueError, and changes nothing,
        when the saved state does not fit the parameters (another count or
        shape): the trainable set changed since it was written."""
        adam = state['adam']
        saved = [i for g in adam['param_groups'] for i in g['params']]
        if len(saved) != len(self.params):
            raise ValueError(f'optimizer state holds {len(saved)} '
                             f'parameters, the model trains '
                             f'{len(self.params)}')
        for i, p in zip(saved, self.params):
            moments = adam['state'].get(i, {})
            for name in ('exp_avg', 'exp_avg_sq'):
                if name in moments and moments[name].shape != p.shape:
                    raise ValueError(
                        f'optimizer state of parameter {i}: {name} '
                        f'{tuple(moments[name].shape)}, the parameter '
                        f'{tuple(p.shape)}')
        # torch's Adam moves the moments to the parameter's device (its
        # 'step' counters stay on the CPU) but keeps tensors that already
        # lie there: copied, so that two optimizers never share them.
        self.adam.load_state_dict(copy.deepcopy(adam))
        self.count = int(state['count'])
