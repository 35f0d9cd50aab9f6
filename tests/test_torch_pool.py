"""Port max-pool (bihome_torch.ops.pool) against the JAX reference
(bihome_tpu.ops.pool.max_pool), forward and backward, on tie-heavy input:
a ReLU output quantized to halves, so most 3x3 windows hold several equal
maxima (mostly zeros). Both routings of the JAX module are checked, the
default XLA autodiff (SelectAndScatter) and the tap backward. Each
window's cotangent must reach the same single element: the gradients are
compared exactly (the only float work is adding a cotangent to an element
that wins several overlapping windows, in the same order up to rounding:
tolerance 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.ops import pool as jpool
from bihome_torch.ops.pool import max_pool_3x3_s2


@pytest.mark.parametrize('backward', ['xla', 'taps'])
@pytest.mark.parametrize('hw', [(16, 16), (15, 17)])
def test_max_pool_tie_routing_matches_jax(monkeypatch, backward, hw):
    monkeypatch.setenv('BIHOME_MAXPOOL_BWD', backward)
    rs = np.random.RandomState(hw[1])
    x = np.maximum(np.round(rs.randn(2, *hw, 3) * 2) / 2, 0).astype(
        np.float32)
    window = ((1, 1), (1, 1))

    def jloss(xj, g):
        return jnp.sum(jpool.max_pool(xj, (3, 3), (2, 2), window) * g)

    want = np.asarray(jpool.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                     window))
    g = rs.randn(*want.shape).astype(np.float32)
    want_dx = np.asarray(jax.grad(jloss)(jnp.asarray(x), jnp.asarray(g)))

    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    xt.requires_grad_(True)
    out = max_pool_3x3_s2(xt)
    (out * torch.from_numpy(np.ascontiguousarray(
        g.transpose(0, 3, 1, 2)))).sum().backward()
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                  want)
    got_dx = xt.grad.permute(0, 2, 3, 1).numpy()
    tied = (x == 0).mean()
    assert tied > 0.4, 'the input should be mostly tied zeros'
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-6)
    # Each window routes to one element: as many nonzero cotangent
    # receivers as JAX's, at the same places.
    np.testing.assert_array_equal(got_dx != 0, want_dx != 0)
