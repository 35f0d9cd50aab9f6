"""Phase times of the timed path from CUDA events that hooks and wrappers
record at the phase ends, with no synchronize added: the events are read
once the window has closed. The hooks are the benchmark's own, registered
on the program's modules and bound methods; they time nothing while
``on`` is false.

A training step's marks, in order: ``start`` (the pool draw,
``trainer.draw_pool_batch``), ``fwd0`` (the backbone's forward pre-hook),
``fwd1`` (its forward hook), ``head1`` (the later gradient hook on the
backbone's outputs: the head and loss backward has reached them),
``bwd1`` (the optimizer's ``global_norm``: the backward is done) and
``opt1`` (the end of the optimizer's ``step``). A serving call's:
``start`` (the serving module's forward pre-hook), ``fwd0``, ``fwd1``,
``end`` (its forward hook).
"""

from __future__ import annotations

from typing import Dict, List

import torch

TRAIN_MARKS = ('start', 'fwd0', 'fwd1', 'head1', 'bwd1', 'opt1')
CALL_MARKS = ('start', 'fwd0', 'fwd1', 'end')


class Recorder:
    def __init__(self, marks, restore=lambda: None):
        self.marks = marks
        self.on = False
        self.units: List[Dict[str, torch.cuda.Event]] = []
        # Undoes what the marks changed outside the hooked objects.
        self.restore = restore

    def mark(self, name: str, later: bool = False) -> None:
        if not self.on:
            return
        if name == 'start':
            self.units.append({})
        unit = self.units[-1] if self.units else None
        if unit is None or (name in unit and not later):
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        unit[name] = ev

    def totals_ms(self) -> Dict[str, float]:
        """Each span's total over the complete units, and their count;
        call after a synchronize."""
        done = [u for u in self.units if all(m in u for m in self.marks)]
        spans: Dict[str, float] = {'units': float(len(done))}
        for a, b in zip(self.marks, self.marks[1:]):
            spans[f'{a}-{b}'] = sum(u[a].elapsed_time(u[b]) for u in done)
        return spans


def install_train(trainer_module, model, optimizer) -> Recorder:
    """Marks on one training object (see the module docstring)."""
    draw = trainer_module.draw_pool_batch
    rec = Recorder(TRAIN_MARKS, lambda: setattr(trainer_module,
                                                'draw_pool_batch', draw))

    def timed_draw(*a, **kw):
        rec.mark('start')
        return draw(*a, **kw)
    trainer_module.draw_pool_batch = timed_draw

    def grad_mark(_grad):
        rec.mark('head1', later=True)

    def fwd_done(_module, _inputs, outputs):
        rec.mark('fwd1')
        if rec.on:
            for t in outputs.values():
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    t.register_hook(grad_mark)
    model.backbone.register_forward_pre_hook(lambda *_: rec.mark('fwd0'))
    model.backbone.register_forward_hook(fwd_done)
    global_norm, step = optimizer.global_norm, optimizer.step

    def timed_global_norm():
        rec.mark('bwd1')
        return global_norm()

    def timed_step():
        lr = step()
        rec.mark('opt1')
        return lr
    optimizer.global_norm = timed_global_norm
    optimizer.step = timed_step
    return rec


def install_call(serving_module) -> Recorder:
    """Marks on one serving module (see the module docstring)."""
    rec = Recorder(CALL_MARKS)
    serving_module.register_forward_pre_hook(lambda *_: rec.mark('start'))
    serving_module.register_forward_hook(lambda *_: rec.mark('end'))
    backbone = serving_module.model.backbone
    backbone.register_forward_pre_hook(lambda *_: rec.mark('fwd0'))
    backbone.register_forward_hook(lambda *_: rec.mark('fwd1'))
    return rec
