"""Port PF head (bihome_torch.ops.fused_head) against the JAX reference
``fused_head.fused_pf_head(train=False)``, the TPU kernel run in Pallas
interpret mode, at M = 2048 and 4096 pixels with one gamma == 0 channel.

On the CPU the wrapper takes the plain path (launch counter stays 0).
Tolerance: rtol 1e-4, atol 1e-4 — float32 on both sides, the same BN fold,
sums in different orders over Cin=16 and Cmid=128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.ops import fused_head as jfh
from bihome_torch.ops import fused_head as tfh


def _params(rs, cin=16, cmid=128, cout=2):
    w1 = (rs.randn(cin, cmid) * 0.3).astype(np.float32)          # flax [I,O]
    b1 = (rs.randn(cmid) * 0.2).astype(np.float32)
    gamma = (1.0 + 0.2 * rs.randn(cmid)).astype(np.float32)
    gamma[0] = 0.0
    beta = (0.1 * rs.randn(cmid)).astype(np.float32)
    w2 = (rs.randn(cmid, cout) * 0.3).astype(np.float32)
    b2 = (0.1 * rs.randn(cout)).astype(np.float32)
    mean = (0.1 * rs.randn(cmid)).astype(np.float32)
    var = (0.5 + rs.rand(cmid)).astype(np.float32)
    return w1, b1, gamma, beta, w2, b2, mean, var


@pytest.mark.parametrize('m', [2048, 4096])
def test_plain_head_matches_pallas_kernel(m):
    rs = np.random.RandomState(m)
    n, hw = m // 1024, (32, 32)
    x = rs.randn(n, hw[0], hw[1], 16).astype(np.float32)          # NHWC
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs)
    want, mu_out, var_out = jfh.fused_pf_head(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(gamma),
        jnp.asarray(beta), jnp.asarray(w2), jnp.asarray(b2),
        jnp.asarray(mean), jnp.asarray(var), train=False)
    np.testing.assert_array_equal(np.asarray(mu_out), mean)

    t = torch.from_numpy
    x_nchw = t(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    w1_t = t(np.ascontiguousarray(w1.T))[:, :, None, None]       # [O,I,1,1]
    w2_t = t(np.ascontiguousarray(w2.T))[:, :, None, None]
    got = tfh.fused_pf_head_fwd(x_nchw, w1_t, t(b1), t(gamma), t(beta), w2_t,
                                t(b2), t(mean), t(var))
    assert tfh.fused_pf_head_fwd.launches == 0
    assert got.shape == (n, 2) + hw
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_plain_head_equals_unfused_composition():
    # The folded arithmetic equals conv -> BN(running stats) -> ReLU -> conv.
    rs = np.random.RandomState(3)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs)
    head = torch.nn.Sequential(torch.nn.Conv2d(16, 128, 1),
                               torch.nn.BatchNorm2d(128), torch.nn.ReLU(),
                               torch.nn.Conv2d(128, 2, 1)).eval()
    with torch.no_grad():
        head[0].weight.copy_(torch.from_numpy(w1.T)[:, :, None, None])
        head[0].bias.copy_(torch.from_numpy(b1))
        head[1].weight.copy_(torch.from_numpy(gamma))
        head[1].bias.copy_(torch.from_numpy(beta))
        head[1].running_mean.copy_(torch.from_numpy(mean))
        head[1].running_var.copy_(torch.from_numpy(var))
        head[3].weight.copy_(torch.from_numpy(w2.T)[:, :, None, None])
        head[3].bias.copy_(torch.from_numpy(b2))
        x = torch.from_numpy(rs.randn(2, 16, 8, 8).astype(np.float32))
        want = head(x)
        got = tfh.pf_head_fwd_plain(
            x, head[0].weight, head[0].bias, head[1].weight, head[1].bias,
            head[3].weight, head[3].bias, head[1].running_mean,
            head[1].running_var, head[1].eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
