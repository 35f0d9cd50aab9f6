"""The port's CUDA kernels against their plain-torch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX, so
it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Edge cases the chip_smoke.py shapes do not reach: ragged pixel counts,
points far outside, exactly on the border or on integer coordinates,
input validation. Tolerances: 1e-3 absolute on 0..255 pixels (warp
forward); 1e-4 (1 + max|out|) (PF head forward; float32, sums in another
order than torch's einsum); 1e-4 (1 + max|ref|) per output of the PF-head
backward (the kernel sums over pixels per block, then over blocks);
1e-3 (1 + max|ref|) for the warp gradients (K5 adds its taps with
atomics, in no fixed order).
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


def test_warp_kernel_rejects_bad_input(cuda):
    img = torch.zeros((2, 8, 8, 1), device=cuda)
    u = torch.zeros((2, 10), device=cuda)
    with pytest.raises(ValueError):
        warp.bilinear_sample_batched(img.double(), u, u)
    with pytest.raises(ValueError):
        warp.bilinear_sample_batched(img, u.t().contiguous().t(), u)
    with pytest.raises(ValueError):
        warp.bilinear_sample_batched(img, u[:1], u[:1])


def _head_args(gen, n, h, w, cuda):
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(cuda)
    gamma = rnd(128, scale=0.2, shift=1.0)
    gamma[0] = 0.0
    return (rnd(n, 16, h, w), rnd(128, 16, 1, 1, scale=0.3),
            rnd(128, scale=0.2), gamma, rnd(128, scale=0.1),
            rnd(2, 128, 1, 1, scale=0.3), rnd(2, scale=0.1),
            rnd(128, scale=0.1), (torch.rand(128, generator=gen) + 0.5).to(cuda))


@pytest.mark.parametrize('shape', [(3, 17, 19), (2, 128, 128), (1, 1, 1)])
def test_pf_head_kernel_matches_plain(cuda, shape):
    args = _head_args(torch.Generator().manual_seed(0), *shape, cuda)
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


def _bwd_args(gen, n, h, w, cuda):
    x, w1, b1, gamma, beta, w2, _, mean, var = _head_args(gen, n, h, w, cuda)
    g = torch.randn((n, 2, h, w), generator=gen).to(cuda)
    gis = gamma * torch.rsqrt(var + 1e-5)
    c1 = gis * (b1 - mean) + beta
    w2gis = (w2.reshape(2, 128).t() * gis[:, None]).contiguous()
    return x, g, w1.reshape(128, 16).contiguous(), gis, c1, w2gis


@pytest.mark.parametrize('shape', [(3, 17, 19), (2, 128, 128), (1, 1, 1)])
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


@pytest.mark.parametrize('channels', [1, 3])
def test_warp_bwd_img_kernel_matches_plain(cuda, channels):
    gen = torch.Generator().manual_seed(20 + channels)
    u, v = _warp_points(gen, 3, 1001, 17, 23, cuda)
    g = torch.randn((3, 1001, channels), generator=gen).to(cuda)
    shape = (3, 17, 23, channels)
    before = warp.bilinear_sample_bwd_img.launches
    got = warp.bilinear_sample_bwd_img(u, v, g, shape)
    torch.cuda.synchronize()
    assert warp.bilinear_sample_bwd_img.launches == before + 1
    want = warp.bilinear_sample_bwd_img_plain(u, v, g, shape)
    tol = 1e-3 * (1.0 + want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


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
