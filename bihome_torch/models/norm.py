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

Across ranks (``bihome_torch.parallel``, world > 1) a training-mode
forward normalises with the global batch's statistics, as JAX's sharded
step does (XLA reduces flax's batch statistics over the devices): each
rank sums its per-channel count, sum and sum of squares (the latter as
its centred sum of squares plus count * mean^2, for precision) and one
all-reduce makes them global. The backward all-reduces the two cotangent
sums the input gradient needs (sum dy, sum dy * x_hat), and takes dgamma
and dbeta from this rank's own sums: the gradient all-reduce of
``training/trainer.py`` sums them over the ranks (summed sums would count
them R times). The running variance stays flax's biased one, which is why
``nn.SyncBatchNorm`` (the unbiased one) is not used.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bihome_torch.parallel import mesh
from bihome_torch.parallel.dist_util import get_world_size

Tensor = torch.Tensor


def global_batch_stats(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(mean, biased variance [C], count []) of x [N,C,H,W] over the global
    batch: per rank a one-pass ``var_mean`` (float32 for a bfloat16 x),
    then one all-reduce of the count, the sums and the sums of squares,
    held in float64."""
    xw = x.float() if x.dtype == torch.bfloat16 else x
    dims = (0, 2, 3)
    var, mean = torch.var_mean(xw, dim=dims, unbiased=False)
    n = x.numel() // x.shape[1]
    mean, var = mean.double(), var.double()
    count, s1, m2, s2 = mesh.sum_over_ranks(
        torch.full((1,), float(n), dtype=torch.float64, device=x.device),
        n * mean, n * var, n * mean * mean)
    total = count[0]
    g_mean = s1 / total
    g_var = ((m2 + s2) / total - g_mean * g_mean).clamp_min(0.0)
    return g_mean, g_var, total


def cotangent_sums(g: Tensor, xhat: Tensor
                   ) -> Tuple[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """((sum dy, sum dy * x_hat) per channel over this rank's pixels, the
    same summed over the ranks)."""
    dims = (0, 2, 3)
    local = (g.sum(dims), (g * xhat).sum(dims))
    return local, tuple(mesh.sum_over_ranks(*local))


class _GlobalBatchNorm(torch.autograd.Function):
    """y = BN(x) with given global statistics, and the backward of the
    batch-statistics BN over the global batch (see the module docstring).
    ``apply(x, weight, bias, mean, var, count, eps)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, eps):
        ctx.save_for_backward(x, weight, mean, var)
        ctx.count, ctx.eps = count, eps
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var = ctx.saved_tensors
        acc = torch.promote_types(x.dtype, torch.float32)
        shape = (1, -1, 1, 1)
        invstd = torch.rsqrt(var.to(acc) + ctx.eps)
        xhat = (x.to(acc) - mean.to(acc).view(shape)) * invstd.view(shape)
        g = dy.to(acc)
        (dbeta, dgamma), (sum_g, sum_gx) = cotangent_sums(g, xhat)
        m = ctx.count.to(acc)
        dx = (weight.to(acc) * invstd).view(shape) * (
            g - (sum_g / m).view(shape) - xhat * (sum_gx / m).view(shape))
        return (dx.to(x.dtype), dgamma.to(weight.dtype),
                dbeta.to(weight.dtype), None, None, None, None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running variance is biased.

    Same parameters, buffers and state-dict keys as ``nn.BatchNorm2d``
    (reference checkpoints load unchanged); eval mode is the parent's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if get_world_size() > 1:
            with torch.no_grad():
                mean, var, count = global_batch_stats(x)
                mean = mean.to(self.running_mean.dtype)
                var = var.to(self.running_var.dtype)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
            return _GlobalBatchNorm.apply(x, self.weight, self.bias, mean,
                                          var, count, self.eps)
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
