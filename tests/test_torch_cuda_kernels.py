"""The port's CUDA kernels against their plain-torch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX, so
it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Edge cases the chip_smoke.py shapes do not reach: ragged pixel counts
(K1's 256-pixel and K2's 64-pixel tiles, the ResNet50-flavour kernels'
128-pixel tiles and 64-pixel sums tiles, K3's and K4's pairs of points),
K1 at Cmid 512 and Cin 16, the wide K2 at Cmid 1024 and with fewer tiles
than SMs, the wide K1's persistent walk at one tile past a multiple of
the SMs, the wide kernels' outputs bit for bit across two calls, one
wgmma tile (tf32, and bf16 in each operand layout) and the weight prep
they read, misaligned inputs, points far
outside,
exactly on the border or on integer coordinates, input validation; K1
and K2 at bfloat16 against their plain bf16 versions (tolerances beside
those tests), and the ResNet50-flavour (Cin 64) K1 and K2 at bfloat16 on
ragged and misaligned shapes. Tolerances: 1e-3 absolute on 0..255 pixels (warp
forward); 1e-4 (1 + max|out|) (PF head forward; float32, sums in another
order than torch's einsum); 1e-4 (1 + max|ref|) per output of the PF-head
backward (the kernel sums over pixels per block, then over blocks);
1e-3 (1 + max|ref|) for the warp gradients (K5 adds its taps with
shared-memory atomics, in no fixed order). K5 also on the grid broadcast
over the batch, at every cluster size, past the shared-memory limit (its
generic path), on misaligned and ragged inputs and over memory that held
NaN. K3's C > 1 kernels at C = 2-5 on ragged, misaligned and border
inputs, K3 on the grid broadcast over the batch (bit for bit against the
grid materialised) and its generic form past the grid's limit.
"""

import pytest
import torch

from bihome_torch.ops import fused_head, warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernels build with nvcc, sm_90a)')
    return torch.device('cuda')


@pytest.mark.parametrize('channels', [1, 3])
def test_warp_kernel_matches_plain(cuda, channels):
    gen = torch.Generator().manual_seed(channels)
    img = (torch.rand((3, 17, 23, channels), generator=gen) * 255).to(cuda)
    u = torch.rand((3, 1001), generator=gen) * 40 - 8
    v = torch.rand((3, 1001), generator=gen) * 34 - 8
    u[0, :6] = torch.tensor([-1e9, 1e9, -1.0, 22.0, 0.0, 3e38])
    v[0, :6] = torch.tensor([5.5, 5.5, 5.5, 16.0, 0.0, 1.0])
    u, v = u.to(cuda), v.to(cuda)
    before = warp.bilinear_sample_batched.launches
    got = warp.bilinear_sample_batched(img, u, v)
    torch.cuda.synchronize()
    assert warp.bilinear_sample_batched.launches == before + 1
    want = warp.bilinear_sample_plain(img, u, v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize('n,p,outside,misalign', [
    (2, 1024, 0.3, False), (3, 1001, 0.3, False), (1, 6, 0.5, False),
    (5, 1, 0.0, False), (7, 4097, 1.0, False), (2, 1024, 0.3, True)])
def test_warp_kernel_c1_tiling(cuda, n, p, outside, misalign):
    # The C = 1 kernels of K3 and K4 on the same points: 2 points a thread,
    # float2 accesses when P is even (P = 1024, 6), scalar ones and a lone
    # last point otherwise (P = 1001, 1, 4097; N*P odd for 3x1001, 5x1 and
    # 7x4097) or when u, v and g sit 4 bytes off an 8-byte boundary; points
    # outside the image (a share of ``outside`` on average, all of them far
    # outside for outside = 1.0); a quarter of the points on integer u and
    # an eighth on integer u and v, where K4's du (dv) must be exactly 0.
    gen = torch.Generator().manual_seed(p)
    h, w = 19, 26
    img = (torch.rand((n, h, w, 1), generator=gen) * 255).to(cuda)
    spread = 1.0 + 2.0 * outside
    u = (torch.rand((n, p), generator=gen) - 0.5) * spread * w + w / 2
    v = (torch.rand((n, p), generator=gen) - 0.5) * spread * h + h / 2
    if outside == 1.0:
        u = u + 10 * w
    u[:, ::4] = torch.round(u[:, ::4])
    v[:, ::8] = torch.round(v[:, ::8])
    g = torch.randn((n, p, 1), generator=gen)

    def place(t):
        # Contiguous, on the card, 4 bytes past an 8-byte boundary if asked.
        flat = torch.empty(t.numel() + 1, device=cuda)
        out = flat[int(misalign):int(misalign) + t.numel()].view(t.shape)
        out.copy_(t)
        return out
    u, v, g = place(u), place(v), place(g)
    before = (warp.bilinear_sample_batched.launches,
              warp.bilinear_sample_bwd_uv.launches)
    got = warp.bilinear_sample_batched(img, u, v)
    du, dv = warp.bilinear_sample_bwd_uv(img, u, v, g)
    torch.cuda.synchronize()
    assert (warp.bilinear_sample_batched.launches,
            warp.bilinear_sample_bwd_uv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = warp.bilinear_sample_plain(img, u, v)
    assert got.shape == (n, p, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    want_du, want_dv = warp.bilinear_sample_bwd_uv_plain(img, u, v, g)
    assert du.shape == dv.shape == (n, p)
    for got_d, want_d in ((du, want_du), (dv, want_dv)):
        tol = 1e-3 * (1.0 + want_d.abs().max().item())
        torch.testing.assert_close(got_d, want_d, rtol=0, atol=tol)
    assert torch.all(du[:, ::4] == 0) and torch.all(dv[:, ::8] == 0)
    if outside == 1.0:
        assert torch.all(got == 0) and torch.all(du == 0) and \
            torch.all(dv == 0)


def _offset_view(t, cuda, floats=1):
    """A contiguous copy of ``t`` on the card whose data starts ``floats``
    floats past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda)
    out = buf[floats:floats + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _k3_counts():
    return (warp.bilinear_sample_batched.launches,
            warp.bilinear_sample_batched.generic_launches)


@pytest.mark.parametrize('c', [2, 3, 4, 5])
@pytest.mark.parametrize('n,p,misalign', [
    (3, 1001, False),   # P odd: scalar u/v loads, blocks off 16 bytes
    (2, 1030, False),   # P % 4 != 0, even: float2 u/v loads
    (2, 1024, True),    # images, u and v one float off alignment
    (5, 7, True),       # fewer points than a thread block's
])
def test_warp_kernel_cn_matches_plain(cuda, c, n, p, misalign):
    # K3's C > 1 kernels: C = 2, 3 and 4 their own (last_kernel C), C = 5
    # the loop over any C (last_kernel 0, counted in generic_launches).
    # Points far outside (+-1e9, 3e38), on the last column and row, and
    # straddling x = -1 and x = W - 1 (one tap of a row's run inside);
    # the output's rows at odd images start off a 16-byte boundary at odd P.
    gen = torch.Generator().manual_seed(100 * c + p)
    h, w = 17, 23
    img = torch.rand((n, h, w, c), generator=gen) * 255
    u = torch.rand((n, p), generator=gen) * (w + 8) - 4
    v = torch.rand((n, p), generator=gen) * (h + 8) - 4
    edge = [(-1e9, 5.5), (1e9, 5.5), (3e38, 2.0), (-3e38, 2.0), (5.5, 1e9),
            (w - 1.0, 7.25), (3.5, h - 1.0), (w - 1.0, h - 1.0),
            (-0.5, 4.5), (w - 1.5, 4.5), (w - 0.5, 4.5), (2.25, -0.5)]
    for i, (x, y) in enumerate(edge[:p]):
        u[0, i], v[0, i] = x, y
    if misalign:
        img, u, v = (_offset_view(t, cuda) for t in (img, u, v))
        assert img.data_ptr() % 16 == 4 and u.data_ptr() % 16 == 4
    else:
        img, u, v = img.to(cuda), u.to(cuda), v.to(cuda)
    before = _k3_counts()
    got = warp.bilinear_sample_batched(img, u, v)
    torch.cuda.synchronize()
    assert _k3_counts() == (before[0] + 1, before[1] + (c > 4))
    assert warp.bilinear_sample_batched.last_kernel == (c if c <= 4 else 0)
    want = warp.bilinear_sample_plain(img, u, v)
    assert got.shape == (n, p, c)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    assert torch.all(got[0, :min(p, 5)] == 0)


@pytest.mark.parametrize('c', [1, 3])
def test_warp_kernel_broadcast_grid_is_bit_identical(cuda, c):
    # One grid row for the whole batch (strides (0, 1), batch stride 0)
    # against the same grid materialised: the same kernel on the same
    # values, bit for bit.
    from bihome_torch.heads.assembled import upsample_grid

    gen = torch.Generator().manual_seed(110 + c)
    n, hw = 5, 24
    img = torch.randn((n, hw, hw, c), generator=gen).to(cuda)
    for scale in (2, 4):
        u, v = upsample_grid(n, hw, hw, scale, cuda)
        assert warp.uv_batch_stride(u, v) == 0
        got = warp.bilinear_sample_batched(img, u, v)
        assert warp.bilinear_sample_batched.last_kernel == c
        full = warp.bilinear_sample_batched(img, u.contiguous(),
                                            v.contiguous())
        torch.cuda.synchronize()
        assert torch.equal(got, full)
        want = warp.bilinear_sample_plain(img, u, v)
        tol = 1e-5 * (1.0 + want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize('c', [1, 3])
def test_warp_kernel_generic_form_past_the_grid_limit(cuda, c):
    # 65,536 images: past the grid's y limit of the C = 1 and C > 1
    # kernels, so the generic form (one thread a point, 64-bit offsets)
    # takes the call, counted in generic_launches (last_kernel -1).
    gen = torch.Generator().manual_seed(120 + c)
    n, p = 65536, 3
    img = (torch.rand((n, 3, 4, c), generator=gen) * 255).to(cuda)
    u = (torch.rand((n, p), generator=gen) * 6 - 1).to(cuda)
    v = (torch.rand((n, p), generator=gen) * 5 - 1).to(cuda)
    before = _k3_counts()
    got = warp.bilinear_sample_batched(img, u, v)
    torch.cuda.synchronize()
    assert _k3_counts() == (before[0] + 1, before[1] + 1)
    assert warp.bilinear_sample_batched.last_kernel == -1
    torch.testing.assert_close(got, warp.bilinear_sample_plain(img, u, v),
                               rtol=0, atol=1e-3)
    row_u, row_v = u[:1].expand(n, -1), v[:1].expand(n, -1)
    torch.testing.assert_close(
        warp.bilinear_sample_batched(img, row_u, row_v),
        warp.bilinear_sample_plain(img, row_u, row_v), rtol=0, atol=1e-3)


def test_upsample_on_card_hands_k3_one_grid_row(cuda, monkeypatch):
    from bihome_torch.heads.assembled import upsample_align_corners

    gen = torch.Generator().manual_seed(130)
    x = torch.randn((3, 16, 16, 1), generator=gen)
    seen = []
    real = warp.bilinear_sample_batched

    def spy(img, uu, vv):
        seen.append((uu.stride(), vv.stride()))
        return real(img, uu, vv)
    # The wrapper counts on the name it is called by: the spy's counters.
    spy.launches = spy.generic_launches = spy.last_kernel = 0
    monkeypatch.setattr(warp, 'bilinear_sample_batched', spy)
    got = upsample_align_corners(x.to(cuda), 4)
    torch.cuda.synchronize()
    assert seen == [((0, 1), (0, 1))]
    assert (spy.launches, spy.generic_launches, spy.last_kernel) == (1, 0, 1)
    want = upsample_align_corners(x, 4)
    tol = 1e-5 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol)


def test_warp_kernel_rejects_bad_input(cuda):
    img = torch.zeros((2, 8, 8, 1), device=cuda)
    u = torch.zeros((2, 10), device=cuda)
    with pytest.raises(ValueError):
        warp.bilinear_sample_batched(img.double(), u, u)
    with pytest.raises(ValueError):
        warp.bilinear_sample_batched(img, u.t().contiguous().t(), u)
    with pytest.raises(ValueError):
        warp.bilinear_sample_batched(img, u[:1], u[:1])


def test_warp_kernel_refuses_other_point_layouts(cuda):
    # K3 takes u and v contiguous or both one row broadcast over the batch
    # (strides (0, 1)), at C = 1 and C > 1 alike.
    gen = torch.Generator().manual_seed(140)
    for c in (1, 3):
        img = torch.rand((3, 8, 8, c), generator=gen).to(cuda)
        u = (torch.rand((3, 64), generator=gen) * 8).to(cuda)
        v = (torch.rand((3, 64), generator=gen) * 8).to(cuda)
        row = u[:1].expand(3, -1)
        for uu, vv in ((u.t().contiguous().t(), v.t().contiguous().t()),
                       (torch.cat([u, u], 1)[:, ::2], v),
                       (row, v)):
            with pytest.raises(ValueError):
                warp.bilinear_sample_batched(img, uu, vv)
        with pytest.raises(ValueError):
            warp.bilinear_sample_batched(img.double(), u, v)


def _head_args(gen, n, h, w, cuda, cmid=128, cin=16):
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(cuda)
    gamma = rnd(cmid, scale=0.2, shift=1.0)
    gamma[0] = 0.0
    return (rnd(n, cin, h, w), rnd(cmid, cin, 1, 1, scale=0.3),
            rnd(cmid, scale=0.2), gamma, rnd(cmid, scale=0.1),
            rnd(2, cmid, 1, 1, scale=0.3), rnd(2, scale=0.1),
            rnd(cmid, scale=0.1),
            (torch.rand(cmid, generator=gen) + 0.5).to(cuda))


# K1 walks 256-pixel tiles inside each image: HW = 323, 1, 48 and 4420 are
# not multiples of 4 or of the tile (4-byte copies for 323 and 1; 48 is one
# image smaller than a tile; 400 and 4420 end in a ragged tile). Cmid 512
# is the ResNet50-flavour head's. The last case has HW % 4 == 0 but x 4
# bytes off a 16-byte boundary (4-byte copies).
@pytest.mark.parametrize('shape,cmid,misalign', [
    ((3, 17, 19), 128, False), ((2, 128, 128), 128, False),
    ((1, 1, 1), 128, False), ((2, 8, 6), 128, False),
    ((3, 20, 20), 128, False), ((1, 68, 65), 128, False),
    ((2, 33, 31), 512, False), ((2, 16, 16), 128, True)])
def test_pf_head_kernel_matches_plain(cuda, shape, cmid, misalign):
    args = list(_head_args(torch.Generator().manual_seed(0), *shape, cuda,
                           cmid))
    if misalign:
        flat = torch.empty(args[0].numel() + 1, device=cuda)
        x = flat[1:].view(args[0].shape)
        x.copy_(args[0])
        args[0] = x
    before = fused_head.fused_pf_head_fwd.launches
    got = fused_head.fused_pf_head_fwd(*args)
    torch.cuda.synchronize()
    assert fused_head.fused_pf_head_fwd.launches == before + 1
    want = fused_head.pf_head_fwd_plain(*args)
    tol = 1e-4 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_pf_head_kernel_rejects_other_widths(cuda):
    args = list(_head_args(torch.Generator().manual_seed(1), 1, 4, 4, cuda))
    args[0] = args[0][:, :8].contiguous()
    args[1] = args[1][:, :8].contiguous()
    with pytest.raises(ValueError, match='Cin=16'):
        fused_head.fused_pf_head_fwd(*args)
    # K1 takes Cmid a multiple of 16 up to 1024 (its shared memory holds
    # g1t's split fragments).
    for cmid in (40, 2048):
        args = _head_args(torch.Generator().manual_seed(1), 1, 4, 4, cuda,
                          cmid)
        with pytest.raises(ValueError, match='Cmid'):
            fused_head.fused_pf_head_fwd(*args)


def _bwd_args(gen, n, h, w, cuda, cmid=128, cin=16):
    x, w1, b1, gamma, beta, w2, _, mean, var = _head_args(gen, n, h, w, cuda,
                                                          cmid, cin)
    g = torch.randn((n, 2, h, w), generator=gen).to(cuda)
    gis = gamma * torch.rsqrt(var + 1e-5)
    c1 = gis * (b1 - mean) + beta
    w2gis = (w2.reshape(2, cmid).t() * gis[:, None]).contiguous()
    return x, g, w1.reshape(cmid, cin).contiguous(), gis, c1, w2gis


# K2 walks 64-pixel tiles inside each image: HW = 323 and 1 are not
# multiples of 4 (4-byte copies); 48 is one image smaller than a tile, 400
# and 4420 end in a ragged tile (16-byte copies).
@pytest.mark.parametrize('shape', [(3, 17, 19), (2, 128, 128), (1, 1, 1),
                                   (2, 8, 6), (3, 20, 20), (1, 68, 65)])
def test_pf_head_bwd_kernel_matches_plain(cuda, shape):
    args = _bwd_args(torch.Generator().manual_seed(2), *shape, cuda)
    before = fused_head.fused_pf_head_bwd.launches
    got = fused_head.fused_pf_head_bwd(*args)
    torch.cuda.synchronize()
    assert fused_head.fused_pf_head_bwd.launches == before + 1
    want = fused_head.pf_head_bwd_plain(*args)
    for name, a, b in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), got, want):
        assert a.shape == b.shape, name
        tol = 1e-4 * (1.0 + b.abs().max().item())
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=name)


def test_pf_head_train_gradients_match_plain(cuda):
    gen = torch.Generator().manual_seed(3)
    x, w1, b1, gamma, beta, w2, b2, _, _ = _head_args(gen, 2, 32, 32, cuda)
    mean, var = fused_head.batch_stats_affine(x, w1, b1)
    g = torch.randn((2, 2, 32, 32), generator=gen).to(cuda)
    got = fused_head.pf_head_backward(x, g, w1, b1, gamma, beta, w2, mean,
                                      var, 1e-5, True)
    want = fused_head.pf_head_backward(x.cpu(), g.cpu(), w1.cpu(), b1.cpu(),
                                       gamma.cpu(), beta.cpu(), w2.cpu(),
                                       mean.cpu(), var.cpu(), 1e-5, True)
    for a, b in zip(got, want):
        tol = 1e-4 * (1.0 + b.abs().max().item())
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol)


def _kink_slack(x, g, w1t, gis, c1, w2gis):
    """How far each output of the PF-head backward (dx, m0, m1, db2, dw1)
    may move where a middle value's float64 pre-activation lies within
    1e-5 of the ReLU kink: there the kernel and the plain version, whose
    sums run in other orders, may take the mask differently, and each such
    value moves dx, M0, M1 and dw1 by at most its whole term."""
    x, g, w1t, gis, c1, w2gis = (t.double() for t in (x, g, w1t, gis, c1,
                                                       w2gis))
    n, cin = x.shape[:2]
    x3, g3 = x.reshape(n, cin, -1), g.reshape(n, g.shape[1], -1)
    mid = torch.einsum('ck,nks->ncs', w1t, x3)
    near = ((gis[:, None] * mid + c1[:, None]).abs() < 1e-5).double()
    e = near * torch.einsum('co,nos->ncs', w2gis, g3).abs()
    return (torch.einsum('ck,ncs->nks', w1t.abs(), e).reshape(x.shape),
            torch.einsum('ncs,nos->co', near, g3.abs()),
            torch.einsum('ncs,nos->co', near * mid.abs(), g3.abs()),
            torch.zeros(g.shape[1], dtype=x.dtype, device=x.device),
            torch.einsum('nks,ncs->kc', x3.abs(), e))


# The ResNet50-flavour kernels (Cin 64): K1 and K2's dx kernel walk
# 128-pixel tiles, K2's sums kernel 64-pixel tiles over 128-channel chunks.
# HW = 323 and 1 are not multiples of 4 (4-byte copies), 48 is smaller than
# a tile, 400, 4420, 200 and 144 end in ragged tiles; Cmid 128 is one
# chunk, 512 the head's four, 1024 the largest taken. 2 x 128 x 128 (256 dx
# tiles, 512 sums tiles) and 3 x 96 x 96 (216, 432) give the persistent
# blocks of an H100's 132 SMs more than one tile each; 1 x 12 x 12 fewer
# tiles than SMs. Each has a gamma == 0 channel. The backward's outputs may
# stray past the tolerance only by _kink_slack, and dx at no more than
# max(2, 1e-4 of its pixels) pixels: the mask flips chip_smoke.py allows at
# full size.
@pytest.mark.parametrize('shape,cmid', [
    ((3, 17, 19), 512), ((2, 64, 64), 512), ((1, 1, 1), 512),
    ((2, 8, 6), 128), ((3, 20, 20), 512), ((1, 68, 65), 256),
    ((2, 10, 20), 1024), ((1, 12, 12), 512), ((2, 128, 128), 512),
    ((3, 96, 96), 512)])
def test_wide_pf_head_kernels_match_plain(cuda, shape, cmid):
    gen = torch.Generator().manual_seed(4)
    args = _head_args(gen, *shape, cuda, cmid, cin=64)
    def counts():
        return (fused_head.fused_pf_head_fwd.launches,
                fused_head.fused_pf_head_fwd.wide_launches,
                fused_head.fused_pf_head_bwd.launches,
                fused_head.fused_pf_head_bwd.wide_launches)
    before = counts()
    got = fused_head.fused_pf_head_fwd(*args)
    bargs = _bwd_args(gen, *shape, cuda, cmid, cin=64)
    got_bwd = fused_head.fused_pf_head_bwd(*bargs)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)
    want = fused_head.pf_head_fwd_plain(*args)
    tol = 1e-4 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    want_bwd = fused_head.pf_head_bwd_plain(*bargs)
    for name, a, b, slack in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), got_bwd,
                                 want_bwd, _kink_slack(*bargs)):
        assert a.shape == b.shape, name
        tol = 1e-4 * (1.0 + b.abs().max().item())
        excess = ((a - b).abs().double() - tol - slack).max().item()
        assert excess <= 0, f'{name}: {excess} past the tolerance and slack'
        if name == 'dx':
            off = int(((a - b).abs() > tol).any(1).sum())
            assert off <= max(2, 1e-4 * a[:, 0].numel()), off


# The wide K1 alone, its persistent blocks (one per SM, 132 on an H100)
# walking one tile more than a multiple of the SMs: 133 and 265 128-pixel
# tiles, so one block takes a tile more than the others; the last shape's
# HW is not a multiple of 4 (4-byte copies) and its last tile is ragged.
@pytest.mark.parametrize('shape', [(1, 133, 128), (5, 53, 128),
                                   (1, 131, 129)])
def test_wide_pf_head_fwd_persistent_walk(cuda, shape):
    args = _head_args(torch.Generator().manual_seed(9), *shape, cuda, 512,
                      cin=64)
    before = fused_head.fused_pf_head_fwd.wide_launches
    got = fused_head.fused_pf_head_fwd(*args)
    torch.cuda.synchronize()
    assert fused_head.fused_pf_head_fwd.wide_launches == before + 1
    want = fused_head.pf_head_fwd_plain(*args)
    tol = 1e-4 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_wide_pf_head_fwd_is_bit_identical(cuda):
    # Each output is summed by one lane quad in a fixed order: two calls on
    # the same inputs give the same bits.
    args = _head_args(torch.Generator().manual_seed(10), 4, 64, 64, cuda,
                      512, cin=64)
    first = fused_head.fused_pf_head_fwd(*args)
    second = fused_head.fused_pf_head_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_wide_pf_head_bwd_sums_are_bit_identical(cuda):
    # The per-block sums are added in a fixed order, with no atomics: two
    # calls on the same inputs give the same bits.
    args = _bwd_args(torch.Generator().manual_seed(7), 4, 64, 64, cuda, 512,
                     cin=64)
    first = fused_head.fused_pf_head_bwd(*args)
    second = fused_head.fused_pf_head_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), first, second):
        assert torch.equal(a, b), name



def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _bf16_counts():
    return (fused_head.fused_pf_head_fwd.launches,
            fused_head.fused_pf_head_fwd.bf16_launches,
            fused_head.fused_pf_head_bwd.launches,
            fused_head.fused_pf_head_bwd.bf16_launches)


# K1 and K2 at bf16 on the shapes of the float32 tests: HW = 323, 1 and
# 4420 are not multiples of 8 (plain loads instead of 16-byte copies), 48
# and 400 are; the misaligned x is 2 bytes off a 16-byte boundary. Both
# round the same float32 values to bf16, summed in other orders: relative
# L2 within 2e-3 (K1) and 5e-3 (K2's dx), every output within 4 bf16 ulps
# of the largest, the sums within 1e-3 relative L2; pixels within 1e-4 of
# the ReLU kink are zeroed first, so both take the same masks.
@pytest.mark.parametrize('shape,cmid,misalign', [
    ((3, 17, 19), 128, False), ((2, 128, 128), 128, False),
    ((1, 1, 1), 128, False), ((2, 8, 6), 128, False),
    ((3, 20, 20), 128, False), ((1, 68, 65), 128, False),
    ((2, 33, 31), 512, False), ((2, 16, 16), 128, True)])
def test_pf_head_bf16_kernel_matches_plain(cuda, shape, cmid, misalign):
    args = list(_head_args(torch.Generator().manual_seed(11), *shape, cuda,
                           cmid))
    x = args[0].to(torch.bfloat16)
    if misalign:
        flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
        x = flat[1:].view(x.shape)
        x.copy_(args[0])
    args[0] = x
    before = _bf16_counts()
    got = fused_head.fused_pf_head_fwd(*args)
    torch.cuda.synchronize()
    assert _bf16_counts() == (before[0], before[1] + 1, *before[2:])
    want = fused_head.pf_head_fwd_plain(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _rel_l2(got, want) <= 2e-3
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2 * want.float().abs().max().item() + 1e-6


def _bf16_bwd_args(gen, n, h, w, cuda, cmid=128, cin=16):
    x, g, w1t, gis, c1, w2gis = _bwd_args(gen, n, h, w, cuda, cmid, cin)
    x = torch.relu(x).to(torch.bfloat16)
    # A zeroed pixel's pre-ReLU value is c1: keep c1 off the kink too.
    c1 = torch.where(c1.abs() > 1e-4, c1, c1 + 3e-4)
    pre = (torch.einsum('ck,nkhw->nchw', w1t.to(torch.bfloat16).double(),
                        x.double()) * gis.double()[:, None, None]
           + c1.double()[:, None, None])
    x.masked_fill_((pre.abs() < 1e-4).any(1)[:, None], 0.0)
    return x, g.to(torch.bfloat16), w1t, gis, c1, w2gis


@pytest.mark.parametrize('shape', [(3, 17, 19), (2, 128, 128), (1, 1, 1),
                                   (2, 8, 6), (3, 20, 20), (1, 68, 65)])
def test_pf_head_bwd_bf16_kernel_matches_plain(cuda, shape):
    args = _bf16_bwd_args(torch.Generator().manual_seed(12), *shape, cuda)
    before = _bf16_counts()
    got = fused_head.fused_pf_head_bwd(*args)
    torch.cuda.synchronize()
    assert _bf16_counts() == (*before[:3], before[3] + 1)
    want = fused_head.pf_head_bwd_plain(*args)
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    for name, a, b in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), got, want):
        assert a.shape == b.shape, name
        assert _rel_l2(a, b) <= (5e-3 if name == 'dx' else 1e-3), name
    err = (got[0].float() - want[0].float()).abs().max().item()
    assert err <= 1.6e-2 * want[0].float().abs().max().item() + 1e-6


def test_pf_head_bf16_kernels_are_bit_identical(cuda):
    # K1 bf16's outputs are summed by one lane quad's products in a fixed
    # order, K2 bf16's dx by one lane, and its per-block sums are added in
    # a fixed order with no atomics: two calls on the same inputs give the
    # same bits. 8 x 128 x 128 pixels are many tiles per persistent block.
    gen = torch.Generator().manual_seed(17)
    args = list(_head_args(gen, 8, 128, 128, cuda))
    args[0] = args[0].to(torch.bfloat16)
    assert torch.equal(fused_head.fused_pf_head_fwd(*args),
                       fused_head.fused_pf_head_fwd(*args))
    bargs = _bf16_bwd_args(gen, 8, 128, 128, cuda)
    first = fused_head.fused_pf_head_bwd(*bargs)
    second = fused_head.fused_pf_head_bwd(*bargs)
    torch.cuda.synchronize()
    for name, a, b in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), first, second):
        assert torch.equal(a, b), name


def test_pf_head_bf16_train_gradients_match_plain(cuda):
    gen = torch.Generator().manual_seed(13)
    x, w1, b1, gamma, beta, w2, b2, _, _ = _head_args(gen, 2, 32, 32, cuda)
    x = torch.relu(x).to(torch.bfloat16)
    mean, var = fused_head.batch_stats_affine(x, w1, b1)
    g = torch.randn((2, 2, 32, 32), generator=gen).to(cuda, torch.bfloat16)
    args = (x, g, w1, b1, gamma, beta, w2, mean, var, 1e-5, True)
    got = fused_head.pf_head_backward(*args)
    want = fused_head.pf_head_backward(
        *(a.cpu() if torch.is_tensor(a) else a for a in args))
    for name, a, b in zip(('dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2',
                           'db2'), got, want):
        assert a.dtype == b.dtype, name
        if name == 'db1':                   # 0 analytically
            continue
        assert _rel_l2(a.cpu(), b) <= (5e-3 if name == 'dx' else 1e-3), name


def test_pf_head_bf16_kernels_reject_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(14)
    wide = list(_head_args(gen, 1, 4, 4, cuda, 1024, cin=64))
    wide[0] = wide[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match='512 for Cin=64 at bfloat16'):
        fused_head.fused_pf_head_fwd(*wide)
    x, g, w1t, gis, c1, w2gis = _bf16_bwd_args(gen, 1, 4, 4, cuda)
    with pytest.raises(ValueError, match='must be torch.bfloat16'):
        fused_head.fused_pf_head_bwd(x, g.float(), w1t, gis, c1, w2gis)
    wx, wg, ww1t, wgis, wc1, ww2gis = _bwd_args(gen, 1, 4, 4, cuda, 1024,
                                                cin=64)
    with pytest.raises(ValueError, match='512 at bfloat16'):
        fused_head.fused_pf_head_bwd(wx.to(torch.bfloat16),
                                     wg.to(torch.bfloat16), ww1t, wgis, wc1,
                                     ww2gis)


def _wide_bf16_counts():
    return tuple(getattr(fn, attr)
                 for fn in (fused_head.fused_pf_head_fwd,
                            fused_head.fused_pf_head_bwd)
                 for attr in ('launches', 'wide_launches', 'bf16_launches',
                              'wide_bf16_launches'))


# The ResNet50-flavour K1 and K2 at bf16 (Cin 64): every kernel walks
# 64-pixel tiles per warpgroup through a ring of stages; HW = 323, 1, 65
# and 4225 are not multiples of 8 (plain loads and stores), 48, 400, 72
# and 32 are (tensor-map copies, zero-filled past the image: 48 and 32 one
# image smaller than a tile, 400 ending in a ragged tile, 65 and 72 one
# pixel and one 8-pixel piece past one);
# 8 x 128 x 128 pixels give every warpgroup several trips around its ring;
# Cmid 128, 256, 384 (an odd number of the sums grid's 128-channel
# chunks) and 512; the misaligned x is 2 bytes off a 16-byte boundary.
# Tolerances as the narrow bf16 tests'; each call must count under
# wide_bf16_launches and nowhere else.
@pytest.mark.parametrize('shape,cmid,misalign', [
    ((3, 17, 19), 512, False), ((2, 64, 64), 512, False),
    ((1, 1, 1), 512, False), ((2, 8, 6), 128, False),
    ((3, 20, 20), 512, False), ((1, 65, 65), 256, False),
    ((2, 16, 16), 512, True), ((2, 5, 13), 512, False),
    ((3, 8, 9), 384, False), ((2, 4, 8), 256, False),
    ((8, 128, 128), 128, False)])
def test_wide_pf_head_bf16_kernels_match_plain(cuda, shape, cmid, misalign):
    gen = torch.Generator().manual_seed(15)
    args = list(_head_args(gen, *shape, cuda, cmid, cin=64))
    x = args[0].to(torch.bfloat16)
    if misalign:
        flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
        x = flat[1:].view(x.shape)
        x.copy_(args[0])
    args[0] = x
    before = list(_wide_bf16_counts())
    got = fused_head.fused_pf_head_fwd(*args)
    torch.cuda.synchronize()
    before[3] += 1
    assert list(_wide_bf16_counts()) == before
    want = fused_head.pf_head_fwd_plain(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _rel_l2(got, want) <= 2e-3
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1.6e-2 * want.float().abs().max().item() + 1e-6

    bargs = list(_bf16_bwd_args(gen, *shape, cuda, cmid, cin=64))
    if misalign:
        flat = torch.empty(bargs[0].numel() + 1, dtype=torch.bfloat16,
                           device=cuda)
        flat[1:].view(bargs[0].shape).copy_(bargs[0])
        bargs[0] = flat[1:].view(bargs[0].shape)
    got = fused_head.fused_pf_head_bwd(*bargs)
    torch.cuda.synchronize()
    before[7] += 1
    assert list(_wide_bf16_counts()) == before
    want = fused_head.pf_head_bwd_plain(*bargs)
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    for name, a, b in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), got, want):
        assert a.shape == b.shape, name
        assert _rel_l2(a, b) <= (5e-3 if name == 'dx' else 1e-3), name
    err = (got[0].float() - want[0].float()).abs().max().item()
    assert err <= 1.6e-2 * want[0].float().abs().max().item() + 1e-6


def test_wide_pf_head_bf16_kernels_are_bit_identical(cuda):
    # K1's outputs are summed by one lane quad in a fixed order, dx by one
    # lane, and K2's per-block sums are added in a fixed order with no
    # atomics: two calls on the same inputs give the same bits.
    gen = torch.Generator().manual_seed(16)
    args = list(_head_args(gen, 4, 64, 64, cuda, 512, cin=64))
    args[0] = args[0].to(torch.bfloat16)
    assert torch.equal(fused_head.fused_pf_head_fwd(*args),
                       fused_head.fused_pf_head_fwd(*args))
    bargs = _bf16_bwd_args(gen, 4, 64, 64, cuda, 512, cin=64)
    first = fused_head.fused_pf_head_bwd(*bargs)
    second = fused_head.fused_pf_head_bwd(*bargs)
    torch.cuda.synchronize()
    for name, a, b in zip(('dx', 'm0', 'm1', 'db2', 'dw1'), first, second):
        assert torch.equal(a, b), name


def _lib():
    from bihome_torch.ops import _cuda
    return _cuda.library('fused_head', fused_head._SIGNATURES)


@pytest.mark.parametrize('mode', [0, 1, 2, 3], ids=[
    'a-regs', 'a-smem', 'a-regs-n32', 'a-smem-n32'])
def test_wgmma_tf32_tile_matches_matmul(cuda, mode):
    # One 64 x 64 x 64 product on wgmma tf32 through the operand images and
    # descriptors the wide K2 uses, A from registers (the mma.m16n8k8
    # fragment per warp) or from shared memory, as one m64n64k8 or as two
    # m64n32k8 halves of N, against float64 on the same TF32 values:
    # products of TF32 values are exact, the sums fp32. A wrong descriptor
    # or fragment layout puts whole entries off.
    from bihome_torch.ops import _cuda
    gen = torch.Generator().manual_seed(8)
    a = fused_head.tf32_rna(torch.randn((64, 64), generator=gen)).to(cuda)
    b = fused_head.tf32_rna(torch.randn((64, 64), generator=gen)).to(cuda)
    d = torch.empty((64, 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    _cuda.check_status(_lib().wgmma_tf32_tile(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), mode, stream),
        'wgmma_tf32_tile')
    torch.cuda.synchronize()
    want = a.double() @ b.double().t()
    torch.testing.assert_close(d.double(), want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize('mode', [0, 1, 2, 3, 4], ids=[
    'a-smem-k-b-k', 'a-smem-mn-b-mn', 'a-regs-b-k', 'a-regs-b-mn',
    'a-regs-b-k-n8'])
def test_wgmma_bf16_tile_matches_matmul(cuda, mode):
    # One 64 x 64 x 64 product on wgmma bf16 through the swizzled tiles
    # and descriptors the wide bf16 kernels use: A from registers (x^T,
    # w1t', e, relu, the mask: the kernels' every A), B K-major (the
    # weights of mid^T, x of dw1, g of M0, w2 of K1's out, the last two at
    # N = 8) or MN-major (x of the sums kernel's mid, w1 of dx); and A from
    # shared memory in both of the tiles' layouts, against float64 on the
    # same bf16 values:
    # their products are exact, the sums fp32. A wrong descriptor, swizzle
    # or transpose bit puts whole entries off.
    from bihome_torch.ops import _cuda
    gen = torch.Generator().manual_seed(9)
    a = torch.randn((64, 64), generator=gen).to(cuda, torch.bfloat16)
    b = torch.randn((64, 64), generator=gen).to(cuda, torch.bfloat16)
    d = torch.empty((64, 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    _cuda.check_status(_lib().wgmma_bf16_tile(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), mode, stream),
        'wgmma_bf16_tile')
    torch.cuda.synchronize()
    want = a.double() @ b.double().t()
    if mode == 4:
        want[:, 8:] = 0.0
    torch.testing.assert_close(d.double(), want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize('cmid', [128, 512, 1024])
def test_wide_weight_prep_matches_plain(cuda, cmid):
    # The prep kernel's split weight images, bit for bit against the plain
    # version (cvt.rna against tf32_rna).
    from bihome_torch.ops import _cuda
    w1t = (torch.randn((cmid, 64), generator=torch.Generator().manual_seed(
        cmid)) * 0.3).to(cuda)
    img = torch.empty((cmid // 64, 4, 64 * 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    _cuda.check_status(_lib().pf_head_wide_prep(
        w1t.data_ptr(), img.data_ptr(), cmid, stream), 'pf_head_wide_prep')
    torch.cuda.synchronize()
    assert torch.equal(img, fused_head.wide_weight_images(w1t))


def test_wide_pf_head_kernels_reject_other_widths(cuda):
    gen = torch.Generator().manual_seed(6)
    for cin, cmid in ((64, 192), (32, 512)):
        with pytest.raises(ValueError, match='Cin=64'):
            fused_head.fused_pf_head_fwd(*_head_args(gen, 1, 4, 4, cuda, cmid,
                                                     cin))
        with pytest.raises(ValueError, match='Cin=64'):
            fused_head.fused_pf_head_bwd(*_bwd_args(gen, 1, 4, 4, cuda, cmid,
                                                    cin))


def _warp_points(gen, n, p, h, w, cuda):
    u = torch.rand((n, p), generator=gen) * (w + 8) - 4
    v = torch.rand((n, p), generator=gen) * (h + 8) - 4
    # Exact integers (K4 must give 0 there), the border, far outside.
    u[0, :8] = torch.tensor([3.0, -1.0, 0.0, w - 1.0, 5.0, -1e9, 1e9, 2.0])
    v[0, :8] = torch.tensor([4.5, 2.25, 7.0, 1.5, 6.0, 1.0, 2.0, 3.0])
    v[1, :3] = torch.tensor([5.0, h - 1.0, 0.0])
    return u.to(cuda), v.to(cuda)


@pytest.mark.parametrize('channels', [1, 3])
def test_warp_bwd_uv_kernel_matches_plain(cuda, channels):
    gen = torch.Generator().manual_seed(10 + channels)
    img = (torch.rand((3, 17, 23, channels), generator=gen) * 255).to(cuda)
    u, v = _warp_points(gen, 3, 1001, 17, 23, cuda)
    g = torch.randn((3, 1001, channels), generator=gen).to(cuda)
    before = warp.bilinear_sample_bwd_uv.launches
    du, dv = warp.bilinear_sample_bwd_uv(img, u, v, g)
    torch.cuda.synchronize()
    assert warp.bilinear_sample_bwd_uv.launches == before + 1
    want_du, want_dv = warp.bilinear_sample_bwd_uv_plain(img, u, v, g)
    for got, want in ((du, want_du), (dv, want_dv)):
        tol = 1e-3 * (1.0 + want.abs().max().item())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    integer_u = u == torch.floor(u)
    integer_v = v == torch.floor(v)
    assert integer_u.any() and integer_v.any()
    assert torch.all(du[integer_u] == 0) and torch.all(dv[integer_v] == 0)


@pytest.mark.parametrize('channels', [1, 2, 3])
def test_warp_bwd_img_kernel_matches_plain(cuda, channels):
    gen = torch.Generator().manual_seed(20 + channels)
    u, v = _warp_points(gen, 3, 1001, 17, 23, cuda)
    g = torch.randn((3, 1001, channels), generator=gen).to(cuda)
    shape = (3, 17, 23, channels)
    before = warp.bilinear_sample_bwd_img.launches
    got = warp.bilinear_sample_bwd_img(u, v, g, shape)
    torch.cuda.synchronize()
    assert warp.bilinear_sample_bwd_img.launches == before + 1
    assert warp.bilinear_sample_bwd_img.last_cluster >= 1
    want = warp.bilinear_sample_bwd_img_plain(u, v, g, shape)
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize('n,h,w,c,p,misalign', [
    (1, 32, 40, 1, 4096, False),   # one sample: few clusters, S up to 4
    (3, 32, 40, 1, 4096, False),   # 16-byte loads
    (3, 32, 40, 2, 4096, False),
    (3, 32, 40, 3, 4096, False),   # any C, cotangents read as added
    (3, 17, 23, 1, 1002, False),   # P % 4 != 0: scalar loads, a tail group
    (3, 32, 40, 1, 4096, True),    # misaligned u, v, g: scalar loads
    (3, 30, 37, 2, 4096, True),    # W * C % 4 != 0: scalar reduction
])
def test_warp_bwd_img_cluster_kernel_edge_cases(cuda, n, h, w, c, p,
                                                misalign):
    gen = torch.Generator().manual_seed(n * 100 + c + p)
    u, v = (t[:n] for t in _warp_points(gen, max(n, 2), p, h, w, cuda))
    g = torch.randn((n, p, c), generator=gen).to(cuda)
    if misalign:
        u, v, g = _misaligned(u), _misaligned(v), _misaligned(g)
        assert u.data_ptr() % 16 == 4
    before = warp.bilinear_sample_bwd_img.launches
    generic = warp.bilinear_sample_bwd_img.generic_launches
    got = warp.bilinear_sample_bwd_img(u, v, g, (n, h, w, c))
    torch.cuda.synchronize()
    assert warp.bilinear_sample_bwd_img.launches == before + 1
    assert warp.bilinear_sample_bwd_img.generic_launches == generic
    assert 1 <= warp.bilinear_sample_bwd_img.last_cluster <= 4
    want = warp.bilinear_sample_bwd_img_plain(u, v, g, (n, h, w, c))
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize('cluster', [1, 2, 3, 4])
@pytest.mark.parametrize('h', [17, 3])
def test_warp_bwd_img_cluster_sizes(cuda, cluster, h):
    # H rows split into bands of unequal height (none for rank 0 at H = 3
    # and S = 4), every block's range of points split unevenly.
    gen = torch.Generator().manual_seed(40 + cluster + h)
    u, v = _warp_points(gen, 3, 2000, h, 24, cuda)
    g = torch.randn((3, 2000, 1), generator=gen).to(cuda)
    got = warp.bilinear_sample_bwd_img(u, v, g, (3, h, 24, 1),
                                       cluster=cluster)
    torch.cuda.synchronize()
    assert warp.bilinear_sample_bwd_img.last_cluster == cluster
    want = warp.bilinear_sample_bwd_img_plain(u, v, g, (3, h, 24, 1))
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize('scale', [2, 4])
def test_warp_bwd_img_broadcast_grid(cuda, scale):
    from bihome_torch.heads.assembled import upsample_grid

    gen = torch.Generator().manual_seed(50 + scale)
    n, hw = 3, 32
    u, v = upsample_grid(n, hw, hw, scale, cuda)
    assert u.stride() == (0, 1) and warp.uv_batch_stride(u, v) == 0
    g = torch.randn((n, u.shape[1], 1), generator=gen).to(cuda)
    shape = (n, hw, hw, 1)
    got = warp.bilinear_sample_bwd_img(u, v, g, shape)
    full = warp.bilinear_sample_bwd_img(u.contiguous(), v.contiguous(), g,
                                        shape)
    torch.cuda.synchronize()
    want = warp.bilinear_sample_bwd_img_plain(u.contiguous(), v.contiguous(),
                                              g, shape)
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(got, full, rtol=0, atol=tol)


def test_warp_bwd_img_generic_path_past_the_shared_memory_limit(cuda):
    # 128 x 240 x 2 floats = 245,760 bytes, past the 232,448 a block of the
    # H100 can hold: the scatter kernel, after its memset.
    gen = torch.Generator().manual_seed(60)
    shape = (2, 128, 240, 2)
    u, v = _warp_points(gen, 2, 5000, 128, 240, cuda)
    g = torch.randn((2, 5000, 2), generator=gen).to(cuda)
    before = (warp.bilinear_sample_bwd_img.launches,
              warp.bilinear_sample_bwd_img.generic_launches)
    got = warp.bilinear_sample_bwd_img(u, v, g, shape)
    torch.cuda.synchronize()
    assert (warp.bilinear_sample_bwd_img.launches,
            warp.bilinear_sample_bwd_img.generic_launches) == (
                before[0] + 1, before[1] + 1)
    assert warp.bilinear_sample_bwd_img.last_cluster == 0
    want = warp.bilinear_sample_bwd_img_plain(u, v, g, shape)
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize('shape', [(3, 32, 40, 1), (2, 128, 240, 2)])
def test_warp_bwd_img_ignores_what_memory_held(cuda, shape):
    # dimg is allocated in memory that held NaN just before the call: the
    # kernel writes every element (the generic path zeroes first).
    gen = torch.Generator().manual_seed(70)
    n, h, w, c = shape
    u, v = _warp_points(gen, n, 3000, h, w, cuda)
    g = torch.randn((n, 3000, c), generator=gen).to(cuda)
    poisoned = torch.full(shape, float('nan'), device=cuda)
    ptr = poisoned.data_ptr()
    del poisoned
    got = warp.bilinear_sample_bwd_img(u, v, g, shape)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    want = warp.bilinear_sample_bwd_img_plain(u, v, g, shape)
    assert torch.isfinite(got).all()
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_warp_bwd_img_refuses_other_point_layouts(cuda):
    gen = torch.Generator().manual_seed(80)
    u, v = _warp_points(gen, 3, 64, 8, 8, cuda)
    g = torch.randn((3, 64, 1), generator=gen).to(cuda)
    row = u[:1].expand(3, -1)
    for uu, vv in ((u.t().contiguous().t(), v.t().contiguous().t()),
                   (torch.cat([u, u], 1)[:, ::2], v),
                   (row, v)):
        with pytest.raises(ValueError):
            warp.bilinear_sample_bwd_img(uu, vv, g, (3, 8, 8, 1))


def test_upsample_image_grad_on_card_matches_cpu(cuda):
    from bihome_torch.heads.assembled import upsample_align_corners

    gen = torch.Generator().manual_seed(90)
    x = torch.randn((2, 16, 16, 1), generator=gen)
    g = torch.randn((2, 64, 64, 1), generator=gen)
    grads = []
    for dev in ('cpu', cuda):
        xd = x.to(dev).detach().requires_grad_(True)
        (upsample_align_corners(xd, 4) * g.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    assert warp.bilinear_sample_bwd_img.last_cluster >= 1
    tol = 1e-3 * (1.0 + grads[0].abs().max().item())
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=tol)


def test_bilinear_sample_function_launches_k4_and_k5(cuda):
    gen = torch.Generator().manual_seed(5)
    img = (torch.rand((2, 9, 11, 1), generator=gen) * 255).to(cuda)
    u = (torch.rand((2, 50), generator=gen) * 10).to(cuda)
    v = (torch.rand((2, 50), generator=gen) * 8).to(cuda)
    img.requires_grad_(True)
    u.requires_grad_(True)
    v.requires_grad_(True)
    counts = (warp.bilinear_sample_bwd_uv.launches,
              warp.bilinear_sample_bwd_img.launches)
    warp.BilinearSample.apply(img, u, v).sum().backward()
    torch.cuda.synchronize()
    assert (warp.bilinear_sample_bwd_uv.launches,
            warp.bilinear_sample_bwd_img.launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    assert img.grad.shape == img.shape and u.grad.shape == u.shape
