"""Max-pool (counterpart of ``bihome_tpu/ops/pool.py:max_pool``).

Forward and backward are ``F.max_pool2d``'s. Its backward sends each
window's cotangent to the window's first maximum in row-major order (the
index it records with a strict ``>``), which is the routing of XLA's
SelectAndScatter and of the JAX module's tap backward
(``bihome_tpu/ops/pool.py:79-128``). That matters here: the stem's pool
follows a ReLU, so ties among zeros are the common case;
``tests/test_torch_pool.py`` pins the routing on tie-heavy input against
JAX. In JAX the pool is an XLA op, not a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 max-pool with 1-pixel padding, NCHW. The padding is
    -inf, as in flax ``nn.max_pool`` with explicit padding."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def max_pool_2x2_s2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max-pool without padding, NCHW (HomographyNet's,
    ``bihome_tpu/models/backbones.py:365``)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
