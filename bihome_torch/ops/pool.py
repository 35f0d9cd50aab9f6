"""Max-pool forward (counterpart of ``bihome_tpu/ops/pool.py:max_pool``).

The JAX module's custom backward (first-max tie routing) is training-only
and not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 max-pool with 1-pixel padding, NCHW. The padding is
    -inf, as in flax ``nn.max_pool`` with explicit padding."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
