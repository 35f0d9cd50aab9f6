"""Port PF head (bihome_torch.ops.fused_head) against the JAX reference
``fused_head.fused_pf_head``, the TPU kernels run in Pallas interpret
mode, with one gamma == 0 channel: the ResNet34-flavour head (Cin 16,
Cmid 128) at M = 2048 and 4096 pixels, and the ResNet50-flavour one (Cin
64, Cmid 512) at M = 8192, where the TPU kernels' 4096-pixel programs
(``_TP_WIDE``) make a grid of two.

On the CPU the wrappers take the plain paths (launch counters stay 0).
Tolerances: eval forward rtol 1e-4, atol 1e-4 — float32 on both sides, the
same BN fold, sums in different orders over Cin and Cmid. Training
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


# (Cin, Cmid, M): both flavours' heads.
SHAPES = [pytest.param(16, 128, 2048, id='2048'),
          pytest.param(16, 128, 4096, id='4096'),
          pytest.param(64, 512, 8192, id='r50-8192')]


@pytest.mark.parametrize('cin,cmid,m', SHAPES)
def test_plain_head_matches_pallas_kernel(cin, cmid, m):
    rs = np.random.RandomState(m)
    n, hw = m // 1024, (32, 32)
    x = rs.randn(n, hw[0], hw[1], cin).astype(np.float32)         # NHWC
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs, cin, cmid)
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
    assert tfh.fused_pf_head_fwd.wide_launches == 0
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


@pytest.mark.parametrize('cin,cmid,m', SHAPES)
def test_train_head_matches_pallas_kernel(cin, cmid, m):
    rs = np.random.RandomState(10 + m)
    n, hw = m // 1024, (32, 32)
    x = rs.randn(n, hw[0], hw[1], cin).astype(np.float32)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs, cin, cmid)
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
    assert tfh.fused_pf_head_fwd.wide_launches == 0
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)
    (got * torch.from_numpy(
        np.ascontiguousarray(cot.transpose(0, 3, 1, 2)))).sum().backward()
    assert tfh.fused_pf_head_bwd.launches == 0
    assert tfh.fused_pf_head_bwd.wide_launches == 0
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


def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest even."""
    bits = a.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -0x2000).view(torch.float32)


def _tf32_product(mode):
    """A float32 matmul on emulated tensor cores: 'single' rounds both
    operands to TF32 once; 'split' is 3xTF32, big*big + big*small +
    small*big with big = tf32(a), small = tf32(a - big). The products of
    TF32 values are exact in float32, as on the card; the sums are float32."""
    def mm(a, b):
        a_big, b_big = _tf32(a), _tf32(b)
        if mode == 'single':
            return a_big @ b_big
        a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
        return a_big @ b_big + (a_big @ b_small + a_small @ b_big)
    return mm


def _moments_tf32(mode, tile=None):
    """K2's one-pass moments with its three Cin x Cmid products (mid, dx,
    dw1) through :func:`_tf32_product`; the rest in float32, as the
    kernel runs it on the fp32 cores. With ``tile``, dw1, M0, M1 and db2
    are summed per ``tile`` pixels of each image first (a fresh
    accumulator each), then over the tiles in order, as the wide sums
    kernel sums them."""
    mm = _tf32_product(mode)

    def moments(x, g, w1t, gis, c1, w2gis):
        n, cin, h, w = x.shape
        x2 = x.permute(1, 0, 2, 3).reshape(cin, -1)                # [Cin,M]
        g2 = g.permute(1, 0, 2, 3).reshape(g.shape[1], -1)         # [Cout,M]
        mid = mm(w1t, x2)                                          # [Cmid,M]
        mask = (gis[:, None] * mid + c1[:, None] > 0).to(x.dtype)
        e = mask * (w2gis @ g2)
        dx = mm(w1t.t().contiguous(), e)                           # [Cin,M]
        dx = dx.reshape(cin, n, h, w).permute(1, 0, 2, 3)
        step = tile or x2.shape[1]
        sums = [0.0] * 4
        for p in range(0, x2.shape[1], step):
            cut = slice(p, p + step)
            parts = (mask[:, cut] @ g2[:, cut].t(),
                     (mask * mid)[:, cut] @ g2[:, cut].t(),
                     g2[:, cut].sum(1),
                     mm(x2[:, cut], e[:, cut].t().contiguous()))
            sums = [a + b for a, b in zip(sums, parts)]
        return (dx, *sums)
    return moments


def _k2_precision(cin, cmid, n, seed, tile=None):
    """Error / max|float64| per gradient of the K2 kernel's arithmetic
    (batch statistics, Cout 2, x [n,Cin,32,32]) through emulated 3xTF32,
    single-pass TF32, and the plain float32 version. dx is compared off
    the pixels where a middle channel's pre-activation lies within 1e-5 of
    the ReLU kink in float64 (chip_smoke's rule); db1 (0 analytically) on
    dbeta's scale."""
    rs = np.random.RandomState(seed)
    h = w = 32
    x = np.maximum(rs.randn(n, cin, h, w), 0.0).astype(np.float32)
    w1, b1, gamma, beta, w2, _, _, _ = _params(rs, cin, cmid)
    cot = rs.randn(n, 2, h, w).astype(np.float32)

    def grads(dtype, moments):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        xt, w1t = t(x), t(w1.T)[:, :, None, None]
        b1t, w2t = t(b1), t(w2.T)[:, :, None, None]
        mean, var = tfh.batch_stats_affine(xt, w1t, b1t)
        return tfh.pf_head_backward(xt, t(cot), w1t, b1t, t(gamma), t(beta),
                                    w2t, mean, var, 1e-5, True,
                                    moments=moments)

    ref = grads(torch.float64, tfh.pf_head_bwd_plain)
    x64 = torch.from_numpy(x).double()
    w1_64 = torch.from_numpy(w1).double()
    mean, var = tfh.batch_stats_affine(
        x64, w1_64.t()[:, :, None, None], torch.from_numpy(b1).double())
    gis = torch.from_numpy(gamma).double() * torch.rsqrt(var + 1e-5)
    c1 = gis * (torch.from_numpy(b1).double() - mean) + \
        torch.from_numpy(beta).double()
    pre = torch.einsum('nkhw,kc->nchw', x64, w1_64) * gis[:, None, None] + \
        c1[:, None, None]
    at_kink = (pre.abs() < 1e-5).any(1, keepdim=True)              # [N,1,H,W]
    names = ('dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2', 'db2')

    def errors(got):
        out = {}
        for i, name in enumerate(names):
            a, b = got[i].double(), ref[i]
            scale = ref[4] if name == 'db1' else b
            if name == 'dx':
                a, b = a.masked_fill(at_kink, 0), b.masked_fill(at_kink, 0)
            out[name] = float((a - b).abs().max() / scale.abs().max())
        return out

    split = errors(grads(torch.float32, _moments_tf32('split', tile)))
    single = errors(grads(torch.float32, _moments_tf32('single', tile)))
    plain = errors(grads(torch.float32, tfh.pf_head_bwd_plain))
    for label, errs in (('3xTF32', split), ('single-pass TF32', single),
                        ('plain float32', plain)):
        print(f'Cin {cin} Cmid {cmid}, error / max|float64| per gradient, '
              f'{label}:', {k: f'{v:.2e}' for k, v in errs.items()})
    return split, single, plain


def test_k2_precision_3xtf32_against_single_pass():
    # The precision choice of the K2 kernel (csrc/fused_head.cu), grounded
    # at its widths (Cin 16, Cmid 128, Cout 2, M = 4096, batch statistics):
    # each of the seven gradients through emulated 3xTF32 products stays
    # within chip_smoke's 1e-3 of max|ref| of float64, and single-pass TF32
    # strays at least 10x further.
    split, single, _ = _k2_precision(16, 128, 4, 11)
    assert max(split.values()) <= 1e-3, split
    assert max(single.values()) >= 10 * max(split.values()), (single, split)


def test_k2_wide_precision_3xtf32_per_tile():
    # The same at the ResNet50-flavour head (Cin 64, Cmid 512, M = 2048),
    # with the wide sums kernel's per-tile summation (64-pixel tiles, each
    # summed apart, then in order): each gradient within chip_smoke's limit,
    # max(1e-3, the plain float32 version's error), of float64, and
    # single-pass TF32 at least 10x further off.
    split, single, plain = _k2_precision(64, 512, 2, 13, tile=64)
    for name, err in split.items():
        assert err <= max(1e-3, plain[name]), (name, split, plain)
    assert max(single.values()) >= 10 * max(split.values()), (single, split)


@pytest.mark.parametrize('cmid', [128, 512])
def test_wide_weight_images_round_trip(cmid):
    # The plain version of the wide K2's weight prep: big + small rebuild
    # w1t to 2^-22 relative, each half has its low 13 mantissa bits zero,
    # and the images give back w1t (rows = channels) and w1 = w1t^T (rows =
    # Cin, channels at their permuted K positions) exactly.
    w1t = torch.from_numpy(
        (np.random.RandomState(cmid).randn(cmid, 64) * 0.3).astype(
            np.float32))
    images = tfh.wide_weight_images(w1t)
    assert images.shape == (cmid // 64, 4, 64 * 64)
    assert not (images.view(torch.int32) & 0x1FFF).any()
    big, small = tfh.split_tf32(w1t)
    rebuilt = (big.double() + small.double())
    assert ((rebuilt - w1t.double()).abs()
            <= 2.0 ** -22 * w1t.double().abs()).all()
    for c in range(cmid // 64):
        rows = slice(64 * c, 64 * c + 64)
        assert torch.equal(tfh.from_image(images[c, 0], False), big[rows])
        assert torch.equal(tfh.from_image(images[c, 1], False), small[rows])
        assert torch.equal(tfh.from_image(images[c, 2], True), big[rows].t())
        assert torch.equal(tfh.from_image(images[c, 3], True),
                           small[rows].t())
    # The permuted K order: position t of each 8 holds channel 2t, t + 4
    # holds 2t + 1.
    probe = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    image = torch.zeros(64 * 64)
    image[tfh._image_offsets(True).reshape(-1)] = probe.reshape(-1)
    flat = image.reshape(16, 8, 8, 4)          # [K quad][row group][row][q]
    assert flat[0, 0, 0].tolist() == [0.0, 2.0, 4.0, 6.0]
    assert flat[1, 0, 0].tolist() == [1.0, 3.0, 5.0, 7.0]


def test_k1_precision_3xtf32_against_single_pass():
    # The precision choice of the K1 kernel (csrc/fused_head.cu), grounded
    # at its widths (Cin 16, Cmid 128, Cout 2, M = 4096, eval statistics):
    # the forward's mid product through emulated 3xTF32 stays within the
    # card tests' 1e-4 (1 + max|out|) of float64, and single-pass TF32
    # strays past it (printed beside). The rest (c1, ReLU, the Cout = 2
    # sums) runs in float32, as the kernel runs it on the fp32 cores.
    rs = np.random.RandomState(12)
    n, h, w = 4, 32, 32
    x = rs.randn(n, 16, h, w).astype(np.float32)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs)
    t = torch.from_numpy
    args = (t(w1.T.copy())[:, :, None, None], t(b1), t(gamma), t(beta),
            t(w2.T.copy())[:, :, None, None], t(b2), t(mean), t(var))
    want = tfh.pf_head_fwd_plain(t(x).double(), *(a.double() for a in args))
    g1t, c1 = tfh.fold_bn(*args[:3], args[3], args[6], args[7], 1e-5)
    x2 = t(x).permute(1, 0, 2, 3).reshape(16, -1)                  # [Cin,M]
    w2m = args[4].reshape(2, -1)

    def forward(mode):
        mid = _tf32_product(mode)(g1t, x2)                         # [Cmid,M]
        out = w2m @ torch.relu(mid + c1[:, None]) + args[5][:, None]
        return out.reshape(2, n, h, w).permute(1, 0, 2, 3)

    scale = float(want.abs().max())
    split, single = (float((forward(mode).double() - want).abs().max())
                     for mode in ('split', 'single'))
    print(f'K1 forward, max abs error against float64 (max|out| {scale:.2f}):'
          f' 3xTF32 {split:.2e}, single-pass TF32 {single:.2e}')
    assert split <= 1e-4 * (1.0 + scale) < single, (split, single)


def _k1_wide_args(rs, cmid):
    """Eval-mode inputs of the wide head (Cin 64): x [4,64,32,32] and the
    torch-layout (w1, b1, gamma, beta, w2, b2, mean, var)."""
    x = rs.randn(4, 64, 32, 32).astype(np.float32)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs, 64, cmid)
    t = torch.from_numpy
    return t(x), (t(w1.T.copy())[:, :, None, None], t(b1), t(gamma),
                  t(beta), t(w2.T.copy())[:, :, None, None], t(b2), t(mean),
                  t(var))


def test_k1_wide_precision_3xtf32_one_accumulator():
    # The order of the wide K1 on wgmma (csrc/fused_head.cu,
    # pf_head_fwd_wgmma_kernel) at its widths (Cin 64, Cmid 512, Cout 2, M
    # = 4096, eval statistics): per 64-channel chunk, mid in one float32
    # accumulator, fed 8 K values at a time, small*big, then big*small,
    # then big*big (cvt.rna splits, as split_tf32); then c1, the ReLU and
    # the Cout = 2 sums over the chunks in float32. It stays within the
    # card tests' 1e-4 (1 + max|out|) of float64, and single-pass TF32
    # (big*big only) strays at least 10x further.
    x, args = _k1_wide_args(np.random.RandomState(21), 512)
    want = tfh.pf_head_fwd_plain(x.double(), *(a.double() for a in args))
    g1t, c1 = tfh.fold_bn(*args[:4], args[6], args[7], 1e-5)
    xb, xs = tfh.split_tf32(x.permute(0, 2, 3, 1).reshape(-1, 64))  # [M,Cin]
    w2m = args[4].reshape(2, -1)

    def forward(mode):
        out = torch.zeros(2, xb.shape[0])
        for c in range(0, 512, 64):
            gb, gs = tfh.split_tf32(g1t[c:c + 64])                # [64,Cin]
            passes = ((xb, gb),) if mode == 'single' else (
                (xs, gb), (xb, gs), (xb, gb))
            mid = torch.zeros(xb.shape[0], 64)
            for a, b in passes:
                for k in range(0, 64, 8):
                    mid = mid + a[:, k:k + 8] @ b[:, k:k + 8].t()
            out = out + w2m[:, c:c + 64] @ torch.relu(mid + c1[c:c + 64]).t()
        out = out + args[5][:, None]
        return out.reshape(2, 4, 32, 32).permute(1, 0, 2, 3)

    scale = float(want.abs().max())
    split, single = (float((forward(mode).double() - want).abs().max())
                     for mode in ('split', 'single'))
    print(f'K1 wide forward, max abs error against float64 (max|out| '
          f'{scale:.2f}): 3xTF32 in one accumulator {split:.2e}, single-pass '
          f'TF32 {single:.2e}')
    assert split <= 1e-4 * (1.0 + scale), (split, scale)
    assert single >= 10 * split, (single, split)


@pytest.mark.parametrize('cmid', [128, 512])
def test_wide_fwd_weight_images_from_folded_g1t(cmid):
    # The wide K1 runs the weight prep on the BN-folded g1t (the scale
    # gamma / sqrt(var + eps) applied, one gamma == 0 channel): its images
    # rebuild g1t to 2^-22 relative, the gamma == 0 channel is a zero row
    # in both halves, and each chunk's first 2 x 4096 floats, the one bulk
    # copy per chunk the forward makes, are g1t's big then small image
    # with rows = channels and K = Cin, exactly.
    _, args = _k1_wide_args(np.random.RandomState(cmid + 1), cmid)
    g1t, _ = tfh.fold_bn(*args[:4], args[6], args[7], 1e-5)
    w1t = args[0].reshape(cmid, 64)
    assert not torch.equal(g1t, w1t)
    images = tfh.wide_weight_images(g1t)
    assert images.shape == (cmid // 64, 4, 64 * 64)
    big, small = tfh.split_tf32(g1t)
    rebuilt = big.double() + small.double()
    assert ((rebuilt - g1t.double()).abs()
            <= 2.0 ** -22 * g1t.double().abs()).all()
    assert not g1t[0].any() and not big[0].any() and not small[0].any()
    copies = images.reshape(cmid // 64, 4 * 64 * 64)[:, :2 * 64 * 64]
    for c in range(cmid // 64):
        rows = slice(64 * c, 64 * c + 64)
        assert torch.equal(tfh.from_image(copies[c, :4096], False),
                           big[rows])
        assert torch.equal(tfh.from_image(copies[c, 4096:], False),
                           small[rows])


@pytest.mark.parametrize('cin,cmid', [(16, 128), (64, 512)],
                         ids=['16-128', '64-512'])
def test_train_head_updates_running_stats_like_flax(cin, cmid):
    rs = np.random.RandomState(7)
    x = rs.randn(3, 16, 16, cin).astype(np.float32)
    w1, b1, gamma, beta, w2, b2, mean, var = _params(rs, cin, cmid)
    variables = {'params': {'conv1_kernel': w1[None, None],
                            'conv1_bias': b1, 'bn_scale': gamma,
                            'bn_bias': beta, 'conv2_kernel': w2[None, None],
                            'conv2_bias': b2},
                 'batch_stats': {'bn_mean': mean, 'bn_var': var}}
    want, mutated = jbb.PFHead(mid=cmid).apply(
        variables, jnp.asarray(x), train=True, mutable=['batch_stats'])

    head = tbb.PFHead(cin, cmid, 2)
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
