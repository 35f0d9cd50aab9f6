"""Port PF head (bihome_torch.ops.fused_head) against the JAX reference
``fused_head.fused_pf_head``, the TPU kernels run in Pallas interpret
mode, at M = 2048 and 4096 pixels with one gamma == 0 channel.

On the CPU the wrappers take the plain paths (launch counters stay 0).
Tolerances: eval forward rtol 1e-4, atol 1e-4 — float32 on both sides, the
same BN fold, sums in different orders over Cin=16 and Cmid=128. Training
(batch statistics): forward and statistics 2e-4; each gradient within
5e-4 of its largest entry (the tolerance of the JAX kernel's own test,
tests/test_fused_head.py), db1 — exactly 0 analytically — at the noise
floor; running statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models import backbones as jbb
from bihome_tpu.ops import fused_head as jfh
from bihome_torch.models import backbones as tbb
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


def _torch_args(x, w1, b1, gamma, beta, w2, b2):
    """NHWC x and flax-layout weights -> NCHW x and torch conv weights,
    each a leaf that requires grad."""
    t = torch.from_numpy
    args = (t(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            t(np.ascontiguousarray(w1.T))[:, :, None, None], t(b1),
            t(gamma), t(beta),
            t(np.ascontiguousarray(w2.T))[:, :, None, None], t(b2))
    return [a.clone().requires_grad_(True) for a in args]


@pytest.mark.parametrize('m', [2048, 4096])
def test_train_head_matches_pallas_kernel(m):
    rs = np.random.RandomState(10 + m)
    n, hw = m // 1024, (32, 32)
    x = rs.randn(n, hw[0], hw[1], 16).astype(np.float32)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs)
    cot = rs.randn(n, hw[0], hw[1], 2).astype(np.float32)

    def jloss(*a):
        y, mu, v = jfh.fused_pf_head(*a, jnp.asarray(mean), jnp.asarray(var),
                                     train=True)
        return jnp.sum(y * cot), (y, mu, v)

    jargs = [jnp.asarray(a) for a in (x, w1, b1, gamma, beta, w2, b2)]
    grads, (want, mu_j, var_j) = jax.grad(jloss, argnums=tuple(range(7)),
                                          has_aux=True)(*jargs)

    targs = _torch_args(x, w1, b1, gamma, beta, w2, b2)
    mu_t, var_t = tfh.batch_stats_affine(targs[0].detach(), targs[1].detach(),
                                         targs[2].detach())
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=2e-4,
                               atol=2e-4)
    got = tfh.FusedPFHead.apply(*targs, mu_t, var_t, 1e-5, True)
    assert tfh.fused_pf_head_fwd.launches == 0
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)
    (got * torch.from_numpy(
        np.ascontiguousarray(cot.transpose(0, 3, 1, 2)))).sum().backward()
    assert tfh.fused_pf_head_bwd.launches == 0
    # JAX layouts: x NHWC, w1 [Cin,Cmid], w2 [Cmid,Cout].
    tgrads = [targs[0].grad.permute(0, 2, 3, 1),
              targs[1].grad[:, :, 0, 0].t()] + \
        [a.grad for a in targs[2:5]] + \
        [targs[5].grad[:, :, 0, 0].t(), targs[6].grad]
    names = ['dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2', 'db2']
    for name, a, b in zip(names, tgrads, grads):
        a, b = a.numpy(), np.asarray(b)
        if name == 'db1':
            assert np.abs(a).max() < 1e-3 and np.abs(b).max() < 1e-3
            continue
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=5e-4,
                                   atol=5e-4, err_msg=name)


def test_train_head_updates_running_stats_like_flax():
    rs = np.random.RandomState(7)
    x = rs.randn(3, 16, 16, 16).astype(np.float32)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs)
    variables = {'params': {'conv1_kernel': w1[None, None],
                            'conv1_bias': b1, 'bn_scale': gamma,
                            'bn_bias': beta, 'conv2_kernel': w2[None, None],
                            'conv2_bias': b2},
                 'batch_stats': {'bn_mean': mean, 'bn_var': var}}
    want, mutated = jbb.PFHead(mid=128).apply(
        variables, jnp.asarray(x), train=True, mutable=['batch_stats'])

    head = tbb.PFHead(16, 128, 2)
    with torch.no_grad():
        for p, v in zip((head[0].weight, head[0].bias, head[1].weight,
                         head[1].bias, head[3].weight, head[3].bias),
                        _torch_args(x, w1, b1, gamma, beta, w2, b2)[1:]):
            p.copy_(v)
        head[1].running_mean.copy_(torch.from_numpy(mean))
        head[1].running_var.copy_(torch.from_numpy(var))
    head.train()
    got = head(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)
    for key, buf in (('bn_mean', head[1].running_mean),
                     ('bn_var', head[1].running_var)):
        np.testing.assert_allclose(
            buf.numpy(), np.asarray(mutated['batch_stats'][key]),
            rtol=1e-5, atol=1e-5, err_msg=key)
