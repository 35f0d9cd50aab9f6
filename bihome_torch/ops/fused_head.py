"""Perspective-field head: 1x1 conv -> BN -> ReLU -> 1x1 conv.

Counterpart of ``bihome_tpu/ops/fused_head.py:fused_pf_head``.

* ``fused_pf_head_fwd`` is the forward (the TPU kernel ``_fwd_kernel``
  driven by ``_run_fwd``). It reads the backbone's NCHW activation
  directly and returns NCHW. BN is folded into the first conv, as
  ``_run_fwd`` does it; the statistics are inputs, running statistics in
  eval mode and batch statistics in training mode.
* ``fused_pf_head_bwd`` is the one-pass backward (the TPU kernel
  ``_bwd_kernel`` driven by ``_run_bwd``): the main ``dx`` term and the
  cross-pixel moments ``dw1``, ``M0``, ``M1``, ``db2``.
  :func:`pf_head_backward` turns them into the seven gradients, with the
  rank-Cin corrections that make it the exact batch-statistics BN
  backward (``_run_bwd:243-270``).
* :class:`FusedPFHead` ties both together for autograd; the batch
  statistics come from :func:`batch_stats_affine` (second moment of x,
  the middle never formed) and get zero cotangent.

Each kernel wrapper takes its plain-torch version for a CPU tensor and
launches ``csrc/fused_head.cu`` (see its header for the H100 bounds and
design) for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bihome_torch.ops import _cuda

Tensor = torch.Tensor

_SIGNATURES = {
    'pf_head_fwd': [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    'pf_head_bwd': [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    'pf_head_bwd_blocks': [ctypes.c_longlong],
    'pf_head_bwd_partial_cols': [],
}


def fold_bn(w1: Tensor, b1: Tensor, gamma: Tensor, beta: Tensor,
            mean: Tensor, var: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """(g1t [Cmid,Cin], c1 [Cmid]) with relu(BN(w1 x + b1)) ==
    relu(g1t x + c1) (ref: bihome_tpu/ops/fused_head.py:180-184)."""
    cmid = w1.shape[0]
    gis = gamma * torch.rsqrt(var + eps)
    g1t = w1.reshape(cmid, -1) * gis[:, None]
    c1 = (b1 - mean) * gis + beta
    return g1t, c1


def batch_stats_affine(x: Tensor, w1: Tensor, b1: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """Exact batch mean and biased variance of mid = w1 x + b1 over all
    pixels of x [N,Cin,H,W], from the mean and second moment of x alone
    (ref: bihome_tpu/ops/fused_head.py:67-86). w1 [Cmid,Cin,1,1]."""
    n, cin = x.shape[:2]
    x3 = x.reshape(n, cin, -1)
    m = x3.shape[0] * x3.shape[2]
    w1f = w1.reshape(w1.shape[0], cin).t()                        # [Cin,Cmid]
    ex = x3.sum(dim=(0, 2)) / m                                   # [Cin]
    s = torch.matmul(x3, x3.transpose(1, 2)).sum(0) / m           # [Cin,Cin]
    mean_lin = ex @ w1f
    mean = mean_lin + b1
    e2_lin = (w1f * (s @ w1f)).sum(0)
    e_mid2 = e2_lin + 2.0 * b1 * mean_lin + b1 * b1
    var = (e_mid2 - mean * mean).clamp_min(0.0)
    return mean, var


def pf_head_fwd_plain(x: Tensor, w1: Tensor, b1: Tensor, gamma: Tensor,
                      beta: Tensor, w2: Tensor, b2: Tensor, mean: Tensor,
                      var: Tensor, eps: float = 1e-5) -> Tensor:
    """Plain-torch version of the same folded arithmetic; materializes the
    [N,Cmid,H,W] middle. x [N,Cin,H,W] -> [N,Cout,H,W]."""
    g1t, c1 = fold_bn(w1, b1, gamma, beta, mean, var, eps)
    a = torch.einsum('jk,nkhw->njhw', g1t, x) + c1[:, None, None]
    w2m = w2.reshape(w2.shape[0], -1)
    return (torch.einsum('oj,njhw->nohw', w2m, torch.relu(a))
            + b2[:, None, None])


def fused_pf_head_fwd(x: Tensor, w1: Tensor, b1: Tensor, gamma: Tensor,
                      beta: Tensor, w2: Tensor, b2: Tensor, mean: Tensor,
                      var: Tensor, eps: float = 1e-5) -> Tensor:
    """x [N,Cin,H,W] float32 (NCHW), conv weights in torch layout
    (w1 [Cmid,Cin,1,1], w2 [Cout,Cmid,1,1]) -> [N,Cout,H,W].
    The CUDA kernel takes Cin=16, Cout=2 (the ResNet34-flavour head)."""
    if x.device.type == 'cpu':
        return pf_head_fwd_plain(x, w1, b1, gamma, beta, w2, b2, mean, var,
                                 eps)
    _cuda.check_cuda_tensor(x, 'x', 4)
    n, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    if cin != 16 or cout != 2 or w1.reshape(cmid, -1).shape[1] != cin:
        raise ValueError(f'the PF-head kernel takes Cin=16, Cout=2; got '
                         f'x {tuple(x.shape)}, w1 {tuple(w1.shape)}, '
                         f'w2 {tuple(w2.shape)}')
    g1t, c1 = fold_bn(w1, b1, gamma, beta, mean, var, eps)
    g1t = g1t.float().contiguous()
    c1 = c1.float().contiguous()
    w2m = w2.reshape(cout, cmid).float().contiguous()
    b2c = b2.float().contiguous()
    for name, t in (('g1t', g1t), ('c1', c1), ('w2', w2m), ('b2', b2c)):
        _cuda.check_cuda_tensor(t, name, t.dim())
    out = torch.empty((n, cout, h, w), dtype=torch.float32, device=x.device)
    lib = _cuda.library('fused_head', _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.pf_head_fwd(x.data_ptr(), g1t.data_ptr(), c1.data_ptr(),
                             w2m.data_ptr(), b2c.data_ptr(), out.data_ptr(),
                             n, cin, h * w, cmid, cout, stream)
    _cuda.check_status(status, 'pf_head_fwd')
    fused_pf_head_fwd.launches += 1
    return out


def pf_head_bwd_plain(x: Tensor, g: Tensor, w1t: Tensor, gis: Tensor,
                      c1: Tensor, w2gis: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain-torch version of the backward pass's arithmetic.

    x [N,Cin,H,W], g [N,Cout,H,W], w1t [Cmid,Cin], gis/c1 [Cmid],
    w2gis [Cmid,Cout] -> (dx [N,Cin,H,W], m0 [Cmid,Cout], m1 [Cmid,Cout],
    db2 [Cout], dw1 [Cin,Cmid]) as defined in ``csrc/fused_head.cu``."""
    n, cin, h, w = x.shape
    x3 = x.reshape(n, cin, h * w)
    g3 = g.reshape(n, g.shape[1], h * w)
    mid = torch.einsum('ck,nks->ncs', w1t, x3)
    mask = (gis[:, None] * mid + c1[:, None] > 0).to(x.dtype)
    e = mask * torch.einsum('co,nos->ncs', w2gis, g3)
    dx = torch.einsum('ck,ncs->nks', w1t, e).reshape(x.shape)
    m0 = torch.einsum('ncs,nos->co', mask, g3)
    m1 = torch.einsum('ncs,nos->co', mask * mid, g3)
    db2 = g3.sum(dim=(0, 2))
    dw1 = torch.einsum('nks,ncs->kc', x3, e)
    return dx, m0, m1, db2, dw1


def fused_pf_head_bwd(x: Tensor, g: Tensor, w1t: Tensor, gis: Tensor,
                      c1: Tensor, w2gis: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward pass (see :func:`pf_head_bwd_plain`); on the card one
    launch of the K2 kernel plus its fixed-order reduction of the
    per-block sums. Takes Cin=16, Cmid=128, Cout=2."""
    if x.device.type == 'cpu':
        return pf_head_bwd_plain(x, g, w1t, gis, c1, w2gis)
    _cuda.check_cuda_tensor(x, 'x', 4)
    _cuda.check_cuda_tensor(g, 'g', 4)
    n, cin, h, w = x.shape
    cmid, cout = w2gis.shape
    if (cin, cmid, cout) != (16, 128, 2) or tuple(g.shape) != (n, cout, h, w) \
            or tuple(w1t.shape) != (cmid, cin):
        raise ValueError(f'the PF-head backward kernel takes Cin=16, '
                         f'Cmid=128, Cout=2; got x {tuple(x.shape)}, '
                         f'g {tuple(g.shape)}, w1t {tuple(w1t.shape)}, '
                         f'w2gis {tuple(w2gis.shape)}')
    for name, t in (('w1t', w1t), ('gis', gis), ('c1', c1),
                    ('w2gis', w2gis)):
        _cuda.check_cuda_tensor(t, name, t.dim())
    lib = _cuda.library('fused_head', _SIGNATURES)
    blocks = lib.pf_head_bwd_blocks(n * h * w)
    if blocks <= 0:
        raise RuntimeError('pf_head_bwd_blocks: no CUDA device')
    cols = lib.pf_head_bwd_partial_cols()
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, cols), dtype=torch.float32,
                          device=x.device)
    sums = torch.empty((cols,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.pf_head_bwd(x.data_ptr(), g.data_ptr(), w1t.data_ptr(),
                             gis.data_ptr(), c1.data_ptr(), w2gis.data_ptr(),
                             dx.data_ptr(), partial.data_ptr(),
                             sums.data_ptr(), n, cin, h * w, cmid, cout,
                             blocks, stream)
    _cuda.check_status(status, 'pf_head_bwd')
    fused_pf_head_bwd.launches += 1
    dw1, m0, m1, db2 = torch.split(sums, [cin * cmid, cmid * cout,
                                          cmid * cout, cout])
    return (dx, m0.view(cmid, cout), m1.view(cmid, cout), db2,
            dw1.view(cin, cmid))


fused_pf_head_fwd.launches = 0
fused_pf_head_bwd.launches = 0


def pf_head_backward(x: Tensor, g: Tensor, w1: Tensor, b1: Tensor,
                     gamma: Tensor, beta: Tensor, w2: Tensor, mean: Tensor,
                     var: Tensor, eps: float, train_stats: bool,
                     moments=fused_pf_head_bwd):
    """Gradients (dx, dw1, db1, dgamma, dbeta, dw2, db2) of the head for
    the output cotangent g, in the layouts of the inputs (torch conv
    weights). With ``train_stats`` the statistics are the batch's own and
    the result is the full batch-statistics BN backward
    (ref: bihome_tpu/ops/fused_head.py:205-270). ``moments`` computes the
    one-pass sums (the K2 wrapper; :func:`pf_head_bwd_plain` to hold the
    kernel against the plain version on the card)."""
    cmid, cin = w1.shape[0], w1.shape[1]
    cout = w2.shape[0]
    n = x.shape[0]
    m = x.numel() // cin
    inv_s = torch.rsqrt(var + eps)
    gis = gamma * inv_s
    cn = inv_s * (b1 - mean)
    c1 = gamma * cn + beta
    w1t = w1.reshape(cmid, cin).contiguous()
    w1f = w1t.t()                                                 # [Cin,Cmid]
    w2f = w2.reshape(cout, cmid).t()                              # [Cmid,Cout]
    w2gis = (w2f * gis[:, None]).contiguous()
    dx, m0, m1, db2, dw1 = moments(x, g.contiguous(), w1t, gis.contiguous(),
                                   c1.contiguous(), w2gis)

    # Mask-side moments -> every BN reduction, with plain w2 (exact at
    # gamma == 0; no division anywhere).
    sum_da = (w2f * m0).sum(1)                                    # [Cmid]
    sum_da_mid = (w2f * m1).sum(1)
    sum_dan = inv_s * sum_da_mid + cn * sum_da                    # dgamma
    dw2 = gis[:, None] * m1 + c1[:, None] * m0                    # [Cmid,Cout]
    db1 = gis * sum_da
    if train_stats:
        k1 = gis * inv_s * (sum_dan / m)
        k0 = -gis * (sum_da / m) - gis * (sum_dan / m) * cn
        # Rank-Cin corrections, all linear in x (see _run_bwd).
        a_mat = (w1f * k1[None, :]) @ w1f.t()                     # [Cin,Cin]
        x3 = x.reshape(n, cin, -1)
        sx = x3.sum(dim=(0, 2))
        sxx = torch.matmul(x3, x3.transpose(1, 2)).sum(0)
        corr = torch.matmul(a_mat, x3).reshape(x.shape)
        dx = dx - corr + (w1f @ k0)[None, :, None, None]
        dw1 = dw1 - (sxx @ w1f) * k1[None, :] + sx[:, None] * k0[None, :]
        db1 = db1 - k1 * (sx @ w1f) + m * k0
    return (dx, dw1.t().reshape(w1.shape), db1, sum_dan, sum_da,
            dw2.t().reshape(w2.shape), db2)


class FusedPFHead(torch.autograd.Function):
    """The head with its hand-written backward.

    ``apply(x, w1, b1, gamma, beta, w2, b2, mean, var, eps, train_stats)``
    -> [N,Cout,H,W]. ``mean``/``var`` are inputs with zero cotangent; in
    training the caller passes :func:`batch_stats_affine` of x under
    ``no_grad`` and ``train_stats=True``, and the backward accounts for
    the statistics' dependence on (x, w1, b1) analytically."""

    @staticmethod
    def forward(ctx, x, w1, b1, gamma, beta, w2, b2, mean, var, eps,
                train_stats):
        ctx.save_for_backward(x, w1, b1, gamma, beta, w2, mean, var)
        ctx.eps = float(eps)
        ctx.train_stats = bool(train_stats)
        return fused_pf_head_fwd(x, w1, b1, gamma, beta, w2, b2, mean, var,
                                 eps)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, gamma, beta, w2, mean, var = ctx.saved_tensors
        grads = pf_head_backward(x, g, w1, b1, gamma, beta, w2, mean, var,
                                 ctx.eps, ctx.train_stats)
        return (*grads, None, None, None, None)
