"""BatchNorm with flax's training semantics (counterpart of the
``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` of
``bihome_tpu/models/backbones.py:104-106`` and ``models/resnet.py``).

In training mode both normalise with the biased batch variance, but they
update the running variance differently: flax with the biased variance,
torch's ``nn.BatchNorm2d`` with the unbiased one (``n / (n - 1)`` times
larger). The port follows flax, so a JAX train state and the port's
running statistics stay equal step for step; the two differ most at small
M = N*H*W, where the tests run. Momentum 0.1 in torch's convention is
flax's 0.9.

A bfloat16 input is normalised as flax's ``nn.BatchNorm(dtype=bfloat16)``
does it (``force_float32_reductions``): the statistics, the running
statistics and the affine in float32, the output rounded to bfloat16.
``F.batch_norm`` does exactly that for a bfloat16 input with float32
parameters and statistics, on the CPU and on the card, so the layer
returns its input's dtype: the compute dtype wherever a convolution feeds
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running variance is biased.

    Same parameters, buffers and state-dict keys as ``nn.BatchNorm2d``
    (reference checkpoints load unchanged); eval mode is the parent's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # Normalise with the batch statistics (torch uses the biased
        # variance here too) and let torch update the running mean. Its
        # variance update adds momentum * the unbiased variance: into a
        # zero buffer here, which is scaled to the biased variance in
        # [C]-sized ops (no second pass over x).
        n = x.numel() // x.shape[1]
        var_share = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, self.running_mean, var_share, self.weight,
                         self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).add_(
                var_share, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y
