"""The port's CUDA kernels against their plain-torch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX, so
it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Edge cases the eval shapes in chip_smoke.py do not reach: ragged pixel
counts, points far outside or exactly on the border, input validation.
Tolerances: 1e-3 absolute on 0..255 pixels (warp); 1e-4 (1 + max|out|)
(PF head; float32, sums in another order than torch's einsum).
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
