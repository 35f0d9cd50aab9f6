"""Convolution and dense layers with a compute dtype, as flax's
``nn.Conv(dtype=...)``, ``nn.ConvTranspose(dtype=...)`` and
``nn.Dense(dtype=...)`` have it (``bihome_tpu/config.py:87-96`` builds
every module with MODEL.DTYPE).

Each layer casts its input, kernel and bias to ``compute_dtype`` and
returns its output in it, the bias added after the product is rounded
(flax computes ``y = dot(x, kernel)`` in the dtype, then ``y += bias``);
the parameters stay float32, so the optimizer
state, the checkpoints and the gradients of the parameters are float32 at
either dtype (the cast's backward brings the gradient back to float32).
A float32 model has ``compute_dtype`` None: its layers cast nothing and
are exactly torch's (so ``model.double()`` still computes in float64, as
the CPU references of the card's checks do). The other modules need no
dtype of their own: BatchNorm reduces in float32 and returns its input's
dtype (:mod:`benchmark.reference.models.norm`), and ReLU, max-pool and the
residual adds keep the dtype they are given.

:func:`set_compute_dtype` sets the dtype of every module of a model that
has one (these layers, the PF head, the decoder's upsampling blocks and
the assembled model), as ``build_model`` passes one dtype to every flax
module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype``, or ``t`` itself where ``dtype`` is None."""
    return t if dtype is None else t.to(dtype)


def widen(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor in float32 (its values exactly), where the bf16
    paths sum in float32; any other tensor unchanged."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _with_bias(product, layer, dt, x, channel_dim):
    """``product(x, weight, bias)`` in ``dt``: torch's own call (bias fused)
    where ``dt`` is None, else the product rounded to ``dt`` and then the
    bias added in ``dt``, as flax does."""
    if dt is None:
        return product(x, layer.weight, layer.bias)
    y = product(x.to(dt), layer.weight.to(dt), None)
    if layer.bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + layer.bias.to(dt).view(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _with_bias(self._conv_forward, self, self.compute_dtype, x, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (no output
    size argument: the decoder's 2x2 / stride-2 upsampling has one
    size)."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def product(x, w, b):
            return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                      self.output_padding, self.groups,
                                      self.dilation)
        return _with_bias(product, self, self.compute_dtype, x, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _with_bias(F.linear, self, self.compute_dtype, x, -1)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Give every submodule with a ``compute_dtype`` (``module`` included)
    the dtype ``dtype`` (float32: None, no casts); the parameters are not
    touched."""
    if dtype not in DTYPES.values():
        raise ValueError(f'compute dtype must be one of {sorted(DTYPES)}, '
                         f'got {dtype}')
    for m in module.modules():
        if hasattr(m, 'compute_dtype'):
            m.compute_dtype = None if dtype == torch.float32 else dtype
    return module
