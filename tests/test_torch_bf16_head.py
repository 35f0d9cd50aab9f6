"""The port's PF head and fused decoder upsampling at bfloat16 against the
JAX reference at bfloat16.

* K1 and K2's plain bf16 versions (``bihome_torch.ops.fused_head``, the
  CPU path of the kernels' wrappers) against
  ``bihome_tpu.ops.fused_head.fused_pf_head`` on bf16 x, the TPU kernels
  run in Pallas interpret mode: Cin 16, Cmid 128, M = 2048 pixels, eval
  (running statistics) and train (batch statistics). Forward within 2e-3
  relative L2; each of the seven gradients of sum(y * cot) within 5e-3
  relative L2 (db1, 0 analytically under batch statistics, at the noise
  floor); at most 1e-2 of y's and of dx's bf16 values other than JAX's.
  Both sides round at the same places (bf16 g1t, relu(a), w2, w1t, e, w1,
  the stored dx, a_mat and the corrected dx) and sum exact bf16 products
  in float32 in other orders, so they differ where a float32 sum lands on
  the other side of a bf16 rounding boundary: a few elements by one bf16
  ulp (3.9e-3 relative; readings: y 0, dx at most 1.4e-4 relative L2 and
  7.0e-4 of its values). The port with any one of its rounding points
  left out must fail these limits (it reads 2.1e-3 to 3.4e-3 on y, or
  4.1e-2 to 0.52 of dx's values). The seeds keep every pre-ReLU value
  more than 1e-5 off the kink (100 times the float32 rounding of its
  sum), where the two sides could take different masks.
* The same at the ResNet50-flavour head (Cin 64, Cmid 512) at M = 4096
  pixels, one ``_TP_WIDE`` program, x a ReLU output, with the same limits
  and planted rounding points. At 2M pre-ReLU values no seed keeps off
  the kink, so beta is moved off it channel by channel (neither statistic
  depends on beta); in training the seed's bf16(g1t) must come out the
  same from either side's batch variance (one flip there moves a whole
  channel: seed 53 reads 1.2e-2 of y's values other than JAX's). Readings:
  eval y 0, dx 3.7e-5 (2.7e-4 of its values); train y 3.6e-5 (4.9e-4 of
  its values), dx 9.9e-5 (8.1e-4); left out, each rounding point reads
  2.4e-3 to 3.9e-3 on y or 2.4e-2 to 0.54 of dx's values.
* The fused deconv + conv3x3 (``bihome_torch.ops.deconv``) against
  ``bihome_tpu.ops.deconv.fused_deconv_conv3x3`` at bf16 (the composite
  kernel rounded to bf16, one convolution, the bias field added in bf16):
  output within 5e-3 relative L2, the gradients of wd, bd, w1 and x within
  1e-2 (the kernel's gradient is rounded to bf16 before the composition
  carries it back, on both sides). At float32 the fused form equals the
  two-op form within 1e-5 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.ops import deconv as jdc
from bihome_tpu.ops import fused_head as jfh
from bihome_torch.ops import deconv as tdc
from bihome_torch.ops import fused_head as tfh
from chip_smoke import skipped_rounding

BF16 = torch.bfloat16
# The head's limits: y and each gradient relative L2, and the share of
# y's and dx's bf16 values that may differ from JAX's by a rounding flip.
HEAD_LIMITS = {'y': 2e-3, 'y differ': 1e-2, 'dx differ': 1e-2}
HEAD_GRAD_L2 = 5e-3


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _head_inputs(seed, n=2, hw=32, cin=16, cmid=128, cout=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, hw, hw, cin).astype(np.float32)               # NHWC
    w1 = (rs.randn(cin, cmid) * 0.3).astype(np.float32)           # [I,O]
    b1 = (rs.randn(cmid) * 0.2).astype(np.float32)
    gamma = (1.0 + 0.2 * rs.randn(cmid)).astype(np.float32)
    gamma[0] = 0.0
    beta = (0.1 * rs.randn(cmid)).astype(np.float32)
    w2 = (rs.randn(cmid, cout) * 0.3).astype(np.float32)
    b2 = (0.1 * rs.randn(cout)).astype(np.float32)
    mean = (0.1 * rs.randn(cmid)).astype(np.float32)
    var = (0.5 + rs.rand(cmid)).astype(np.float32)
    cot = rs.randn(n, hw, hw, cout).astype(np.float32)
    return (x, w1, b1, gamma, beta, w2, b2, mean, var), cot


def _pre_relu_margin(x, w1, b1, gamma, beta, mean, var, train):
    """The smallest |pre-ReLU value| of the head (float64, bf16 x)."""
    x = np.asarray(torch.from_numpy(x).to(BF16).double())
    mid = x.reshape(-1, x.shape[-1]) @ w1.astype(np.float64) + b1
    if train:
        mean, var = mid.mean(0), mid.var(0)
    a = (mid - mean) / np.sqrt(var + 1e-5) * gamma + beta
    return float(np.abs(a[:, gamma != 0]).min())


def _port_head(x, w1, b1, gamma, beta, w2, b2, mean, var, cot, train):
    """The port's head at bf16 x on the CPU (the plain bf16 versions) ->
    (y [N,H,W,Cout] float32, its bf16 values, the seven gradients of
    sum(y * cot) in JAX's layouts)."""
    t = torch.from_numpy
    targs = [t(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(BF16),
             t(np.ascontiguousarray(w1.T))[:, :, None, None], t(b1),
             t(gamma), t(beta),
             t(np.ascontiguousarray(w2.T))[:, :, None, None], t(b2)]
    targs = [a.clone().requires_grad_(True) for a in targs]
    if train:
        mu_t, var_t = tfh.batch_stats_affine(
            targs[0].detach(), targs[1].detach(), targs[2].detach())
    else:
        mu_t, var_t = t(mean), t(var)
    got = tfh.FusedPFHead.apply(*targs, mu_t, var_t, 1e-5, train)
    assert got.dtype == BF16
    (got.float() * t(np.ascontiguousarray(
        cot.transpose(0, 3, 1, 2)))).sum().backward()
    assert targs[0].grad.dtype == BF16
    # JAX layouts: x NHWC, w1 [Cin,Cmid], w2 [Cmid,Cout].
    tgrads = [targs[0].grad.float().permute(0, 2, 3, 1),
              targs[1].grad[:, :, 0, 0].t()] + \
        [a.grad for a in targs[2:5]] + \
        [targs[5].grad[:, :, 0, 0].t(), targs[6].grad]
    return (got.detach().float().permute(0, 2, 3, 1).numpy(),
            [a.numpy() for a in tgrads], (mu_t, var_t))


GRAD_NAMES = ('dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2', 'db2')


def _head_errors(got, want, train):
    """Relative L2 of y and of each gradient (db1 under batch statistics,
    0 analytically, left out), and the share of y's and dx's bf16 values
    that differ from JAX's."""
    y, grads, _ = got
    y_j, grads_j = want
    errs = {'y': rel_l2(y, y_j), 'y differ': float(np.mean(y != y_j)),
            'dx differ': float(np.mean(grads[0] != grads_j[0]))}
    for name, a, b in zip(GRAD_NAMES, grads, grads_j):
        if not (name == 'db1' and train):
            errs[name] = rel_l2(a, b)
    return errs


def _head_holds(errs):
    return all(v <= HEAD_LIMITS.get(k, HEAD_GRAD_L2) for k, v in errs.items())


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_plain_bf16_head_matches_pallas_kernels(train):
    args, cot = _head_inputs(seed=47 if train else 24)
    x, w1, b1, gamma, beta, w2, b2, mean, var = args
    assert _pre_relu_margin(x, w1, b1, gamma, beta, mean, var, train) > 1e-5

    def jloss(*a):
        y, mu, v = jfh.fused_pf_head(*a, jnp.asarray(mean), jnp.asarray(var),
                                     train=train)
        return jnp.sum(y * jnp.asarray(cot)), (y, mu, v)

    jargs = [jnp.asarray(x).astype(jnp.bfloat16)] + [
        jnp.asarray(a) for a in (w1, b1, gamma, beta, w2, b2)]
    grads, (want, mu_j, var_j) = jax.grad(
        jloss, argnums=tuple(range(7)), has_aux=True)(*jargs)
    assert want.dtype == jnp.bfloat16 and grads[0].dtype == jnp.bfloat16
    want = (np.asarray(want, np.float32),
            [np.asarray(g, np.float32) for g in grads])

    got = _port_head(*args, cot, train)
    if train:
        mu_t, var_t = got[2]
        assert rel_l2(mu_t, mu_j) < 1e-5 and rel_l2(var_t, var_j) < 1e-5
    else:
        assert float(np.abs(grads[2]).max()) > 0
    assert tfh.fused_pf_head_fwd.bf16_launches == 0
    assert tfh.fused_pf_head_bwd.bf16_launches == 0
    errs = _head_errors(got, want, train)
    if train:
        assert (float(np.abs(got[1][2]).max()) < 1e-2
                and float(np.abs(want[1][2]).max()) < 1e-2)
    print('port against JAX at bf16: ' + ', '.join(
        f'{k} {v:.2e}' for k, v in errs.items()))
    assert _head_holds(errs), errs

    # Each rounding point left out (in call order: g1t, w2, relu(a)
    # forward; w1t, e and, with batch statistics, a_mat backward) must fail
    # the same limits.
    for k in range(6 if train else 5):
        with skipped_rounding(k):
            planted = _head_errors(_port_head(*args, cot, train), want, train)
        print(f'rounding point {k} left out: ' + ', '.join(
            f'{key} {v:.2e}' for key, v in planted.items()))
        assert not _head_holds(planted), (k, planted)


def _off_the_kink(args, train, margin=1e-5):
    """``args`` with beta moved, in steps of 10 margins, in each channel
    where some pixel's pre-ReLU value (float64, bf16 x) lies within 2
    margins of 0: at Cin 64 / Cmid 512 the 4096 pixels' 2M pre-ReLU values
    put some within 1e-5 of the kink for any seed. Neither statistic
    depends on beta, so no other value moves."""
    x, w1, b1, gamma, beta, w2, b2, mean, var = args
    xb = np.asarray(torch.from_numpy(x).to(BF16).double())
    mid = xb.reshape(-1, x.shape[-1]) @ w1.astype(np.float64) + b1
    mu, v = (mid.mean(0), mid.var(0)) if train else (mean, var)
    z = (mid - mu) / np.sqrt(v + 1e-5) * gamma
    beta = beta.astype(np.float64)
    for c in range(beta.size):
        while np.abs(z[:, c] + beta[c]).min() <= 2 * margin:
            beta[c] += 10 * margin
    return x, w1, b1, gamma, beta.astype(np.float32), w2, b2, mean, var


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_plain_bf16_wide_head_matches_pallas_kernels(train):
    """The ResNet50-flavour head (Cin 64, Cmid 512) at M = 4096 pixels, one
    _TP_WIDE program of the Pallas kernels, with the narrow test's limits
    and planted rounding points. x is a ReLU output (the decoder's); beta
    keeps every pre-ReLU value more than 1e-5 off the kink
    (:func:`_off_the_kink`)."""
    args, cot = _head_inputs(seed=58 if train else 52, n=1, hw=64, cin=64,
                             cmid=512)
    args = _off_the_kink((np.maximum(args[0], 0.0), *args[1:]), train)
    x, w1, b1, gamma, beta, w2, b2, mean, var = args
    assert _pre_relu_margin(x, w1, b1, gamma, beta, mean, var, train) > 1e-5

    def jloss(*a):
        y, mu, v = jfh.fused_pf_head(*a, jnp.asarray(mean), jnp.asarray(var),
                                     train=train)
        return jnp.sum(y * jnp.asarray(cot)), (y, v)

    jargs = [jnp.asarray(x).astype(jnp.bfloat16)] + [
        jnp.asarray(a) for a in (w1, b1, gamma, beta, w2, b2)]
    grads, (want, var_j) = jax.grad(jloss, argnums=tuple(range(7)),
                                    has_aux=True)(*jargs)
    assert want.dtype == jnp.bfloat16 and grads[0].dtype == jnp.bfloat16
    want = (np.asarray(want, np.float32),
            [np.asarray(g, np.float32) for g in grads])
    got = _port_head(*args, cot, train)
    # bf16(g1t) the same from either side's statistics (the two sums of the
    # variance differ in float32's last bits; a g1t value on a bf16
    # rounding boundary would flip a whole channel's products: seed 53 has
    # one such, and 1.2e-2 of y's values then differ).
    t = torch.from_numpy
    g1t = [tfh.fold_bn(t(np.ascontiguousarray(w1.T)), t(b1), t(gamma),
                       t(beta), t(mean), t(np.array(v, np.float32)),
                       1e-5)[0].to(BF16) for v in (got[2][1], var_j)]
    assert torch.equal(*g1t)
    assert tfh.fused_pf_head_fwd.wide_bf16_launches == 0
    assert tfh.fused_pf_head_bwd.wide_bf16_launches == 0
    errs = _head_errors(got, want, train)
    print('wide head, port against JAX at bf16: ' + ', '.join(
        f'{k} {v:.2e}' for k, v in errs.items()))
    assert _head_holds(errs), errs
    for k in range(6 if train else 5):
        with skipped_rounding(k):
            planted = _head_errors(_port_head(*args, cot, train), want, train)
        print(f'rounding point {k} left out: ' + ', '.join(
            f'{key} {v:.2e}' for key, v in planted.items()))
        assert not _head_holds(planted), (k, planted)


def _deconv_inputs(seed, n=2, cin=8, cout=8, h=6, w=5):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, cin).astype(np.float32)                 # NHWC
    wd = (rs.randn(2, 2, cin, cin) * 0.4).astype(np.float32)      # [kh,kw,O,I]
    bd = (rs.randn(cin) * 0.3).astype(np.float32)
    w1 = (rs.randn(3, 3, cin, cout) * 0.2).astype(np.float32)     # HWIO
    cot = rs.randn(n, 2 * h, 2 * w, cout).astype(np.float32)
    return x, wd, bd, w1, cot


def _torch_deconv_args(x, wd, bd, w1):
    t = torch.from_numpy
    return [t(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            t(np.ascontiguousarray(wd.transpose(3, 2, 0, 1))),    # [I,O,2,2]
            t(bd),
            t(np.ascontiguousarray(w1.transpose(3, 2, 0, 1)))]    # OIHW


def test_fused_deconv_equals_two_op_form_at_float32():
    x, wd, bd, w1, _ = _deconv_inputs(seed=30)
    xt, wdt, bdt, w1t = _torch_deconv_args(x, wd, bd, w1)
    two = torch.nn.functional.conv2d(
        torch.nn.functional.conv_transpose2d(xt, wdt, bdt, stride=2), w1t,
        padding=1)
    fused = tdc.fused_deconv_conv3x3(xt, wdt, bdt, w1t, torch.float32)
    assert float((fused - two).abs().max()) <= 1e-5 * float(two.abs().max())


def test_fused_deconv_matches_jax_at_bf16():
    x, wd, bd, w1, cot = _deconv_inputs(seed=31)

    def jloss(xj, wdj, bdj, w1j):
        y = jdc.fused_deconv_conv3x3(xj, wdj, bdj, w1j, dtype=jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot)), y

    grads, want = jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a) for a in (x, wd, bd, w1)])
    assert want.dtype == jnp.bfloat16

    targs = [a.requires_grad_(True)
             for a in _torch_deconv_args(x, wd, bd, w1)]
    got = tdc.fused_deconv_conv3x3(*targs, BF16)
    assert got.dtype == BF16
    assert rel_l2(got.detach().float().permute(0, 2, 3, 1),
                  np.asarray(want, np.float32)) <= 5e-3
    (got.float() * torch.from_numpy(np.ascontiguousarray(
        cot.transpose(0, 3, 1, 2)))).sum().backward()
    tgrads = [targs[0].grad.permute(0, 2, 3, 1),
              targs[1].grad.permute(2, 3, 1, 0), targs[2].grad,
              targs[3].grad.permute(2, 3, 1, 0)]
    for name, a, b in zip(('x', 'wd', 'bd', 'w1'), tgrads, grads):
        err = rel_l2(a.float().numpy(), np.asarray(b, np.float32))
        assert err <= 1e-2, (name, err)
