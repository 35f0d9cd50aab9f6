"""The operations of one training step or one serving call, counted once
per run with ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference at the cell's shapes (forward and backward for a step, the
forward for a call): the convolutions and matrix products, whatever
implements them in the program. Divided by the TF32 peak
(``peaks.json``), the highest published rate on float32 inputs, it gives
the whole step's share of the card's peak, which cannot pass 100%."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import step


def train_step_flops(built: step.Built, pool: torch.Tensor, batch: int,
                     seed: int) -> int:
    """One reference step at ``batch`` on ``pool`` (weights as they are)."""
    device = pool.device
    gens = (torch.Generator(device=device).manual_seed(seed),
            torch.Generator().manual_seed(seed),
            torch.Generator().manual_seed(seed + 1))
    with FlopCounterMode(display=False) as counter:
        step.train_steps(built, pool, batch, 1, *gens)
    return int(counter.get_total_flops())


def predict_flops(built: step.Built, patch_1: torch.Tensor,
                  patch_2: torch.Tensor, uniforms) -> int:
    """One reference serving call on these patches."""
    with FlopCounterMode(display=False) as counter:
        step.predict(built, patch_1, patch_2, uniforms)
    return int(counter.get_total_flops())
