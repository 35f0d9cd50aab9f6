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

At bfloat16 (MODEL.DTYPE bfloat16) x, the output, the cotangent g and dx
are bfloat16, as the Pallas kernels' are when the PF head hands them bf16
x; the weights, statistics and the other gradients stay float32. The
plain versions then round where the Pallas kernels round (g1t, relu(a)
and w2 in the forward; w1t, e, w1, the stored dx, a_mat and the
corrected dx in the backward) and sum in float32, at either width. On the
card the narrow (Cin 16) head launches the narrow bf16 kernels and the
wide (Cin 64) head the wide bf16 ones, each counted apart
(``bf16_launches``, ``wide_bf16_launches``); no bf16 call reaches the
float32 kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bihome_torch.models.layers import widen
from bihome_torch.ops import _cuda

Tensor = torch.Tensor

_SIGNATURES = {
    'pf_head_fwd': [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    'pf_head_bwd': [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    'pf_head_bwd_blocks': [ctypes.c_longlong, ctypes.c_int],
    'pf_head_bwd_bf16_blocks': [ctypes.c_longlong, ctypes.c_int],
    'pf_head_bwd_partial_cols': [],
    'pf_head_fwd_wide': [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    'pf_head_bwd_wide': [ctypes.c_void_p] * 10 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    'pf_head_bwd_wide_blocks': [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int],
    'pf_head_wide_prep': [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_void_p],
    'wgmma_tf32_tile': [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p],
    'pf_head_fwd_bf16': [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    'pf_head_bwd_bf16': [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_SIGNATURES['pf_head_fwd_wide_bf16'] = _SIGNATURES['pf_head_fwd_bf16']
_SIGNATURES['pf_head_bwd_wide_bf16'] = _SIGNATURES['pf_head_bwd_bf16']
_SIGNATURES['wgmma_bf16_tile'] = _SIGNATURES['wgmma_tf32_tile']
# The largest Cmid the kernels take (kFwdMaxCmid and kWMaxCmid in the
# source; the wide bf16 ones kWBMaxCmid); the wide ones (Cin 64) take
# multiples of 128.
_MAX_CMID = 1024
_WIDE_BF16_MAX_CMID = 512
_WIDE_CIN, _WIDE_CMID_STEP = 64, 128


def _kernel_width(cin: int, cmid: int, cout: int, bf16: bool) -> str:
    """'narrow' (the ResNet34-flavour kernels: Cin 16, Cmid a multiple of
    16), 'wide' (the ResNet50-flavour ones: Cin 64, Cmid a multiple of
    128), or '' for a shape neither takes; Cout 2, Cmid up to 1024 (512
    for the wide bf16 kernels)."""
    if cout != 2 or not 0 < cmid <= _MAX_CMID:
        return ''
    if cin == 16 and cmid % 16 == 0:
        return 'narrow'
    if (cin == _WIDE_CIN and cmid % _WIDE_CMID_STEP == 0
            and not (bf16 and cmid > _WIDE_BF16_MAX_CMID)):
        return 'wide'
    return ''


def _counter(width: str, bf16: bool) -> str:
    """The wrappers' launch counter of a kernel: ``launches`` (narrow
    float32), ``wide_launches``, ``bf16_launches`` (narrow bf16) or
    ``wide_bf16_launches``."""
    return ('wide_' if width == 'wide' else '') + (
        'bf16_' if bf16 else '') + 'launches'


def wide_sums_cols(cin: int, cmid: int, cout: int) -> int:
    """Columns of the wide backward's sums: dw1 | M0 | M1 | db2."""
    return cin * cmid + 2 * cmid * cout + cout


def tf32_rna(t: Tensor) -> Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, the low 13 mantissa bits zero."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: Tensor) -> Tuple[Tensor, Tensor]:
    """(big, small) of float32 t for 3xTF32: big = tf32(t), small =
    tf32(t - big), as the kernels split their operands."""
    big = tf32_rna(t)
    return big, tf32_rna(t.float() - big)


def _image_offsets(permuted: bool) -> Tensor:
    """[64, 64] offsets (floats) of element (row r, K index k) in a wgmma
    operand image of ``csrc/fused_head.cu`` (``img_at``): core matrices of 8
    rows x 4 K values, (K quad, row group) at (kc * 8 + rg) * 32. With
    ``permuted`` k is first placed at its accumulator-to-A position
    (``perm_k``: within each 8, positions 0..3 hold 0,2,4,6, 4..7 hold
    1,3,5,7)."""
    r = torch.arange(64)[:, None]
    k = torch.arange(64)[None, :]
    if permuted:
        k = (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3)
    return (((k >> 2) * 8 + (r >> 3)) * 8 + (r & 7)) * 4 + (k & 3)


def wide_weight_images(w1t: Tensor) -> Tensor:
    """Plain version of the wide kernels' weight prep
    (``pf_head_wide_prep_kernel``): w1t [Cmid,64] -> [Cmid/64, 4, 4096],
    per 64 channels the images of w1t (rows = channels, K = Cin) big and
    small, then of w1 = w1t^T (rows = Cin, K = channels permuted) big and
    small. The backward splits w1t, the forward the BN-folded g1t and reads
    the first two images of each chunk."""
    cmid, cin = w1t.shape
    big, small = split_tf32(w1t)
    plain, perm = _image_offsets(False), _image_offsets(True)
    out = torch.empty((cmid // 64, 4, 64 * 64), dtype=torch.float32,
                      device=w1t.device)
    for c in range(cmid // 64):
        for i, half in enumerate((big, small)):
            chunk = half[c * 64:(c + 1) * 64]                     # [ch, Cin]
            out[c, i, plain.reshape(-1).to(w1t.device)] = chunk.reshape(-1)
            out[c, 2 + i, perm.reshape(-1).to(w1t.device)] = \
                chunk.t().reshape(-1)
    return out


def _wide_image_scratch(cmid: int, device) -> Tensor:
    """The wide kernels' scratch for their split weight images (see
    :func:`wide_weight_images`)."""
    return torch.empty((cmid // 64, 4, 64 * 64), dtype=torch.float32,
                       device=device)


def from_image(image: Tensor, permuted: bool) -> Tensor:
    """The [64, 64] matrix (rows, K) that a 4096-float image holds."""
    return image[_image_offsets(permuted).to(image.device)]


_WIDTHS = ('Cout=2 with Cin=16 and Cmid a multiple of 16, or Cin=64 and '
           'Cmid a multiple of 128, Cmid up to 1024 (512 for Cin=64 at '
           'bfloat16)')


def _rounded(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t`` rounded to bfloat16's values (kept in float32) where
    ``dtype`` is bfloat16, the rounding points of the Pallas kernels at
    bf16 (``x.dtype`` casts in ``bihome_tpu/ops/fused_head.py``); ``t``
    itself otherwise."""
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


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
    (ref: bihome_tpu/ops/fused_head.py:67-86). w1 [Cmid,Cin,1,1]. A
    bfloat16 x is summed in float32 (bf16 products are exact there)."""
    n, cin = x.shape[:2]
    x3 = widen(x).reshape(n, cin, -1)
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
    [N,Cmid,H,W] middle. x [N,Cin,H,W] -> [N,Cout,H,W] in x's dtype. At
    bfloat16: bf16(g1t), bf16(relu(a)) and bf16(w2), float32 sums, the
    output rounded to bf16 (``_fwd_kernel`` and ``_run_fwd:201,283``)."""
    dt = x.dtype
    g1t, c1 = fold_bn(w1, b1, gamma, beta, mean, var, eps)
    a = (torch.einsum('jk,nkhw->njhw', _rounded(g1t, dt), widen(x))
         + c1[:, None, None])
    w2m = _rounded(w2.reshape(w2.shape[0], -1), dt)
    return (torch.einsum('oj,njhw->nohw', w2m,
                         _rounded(torch.relu(a), dt))
            + b2[:, None, None]).to(dt)


def fused_pf_head_fwd(x: Tensor, w1: Tensor, b1: Tensor, gamma: Tensor,
                      beta: Tensor, w2: Tensor, b2: Tensor, mean: Tensor,
                      var: Tensor, eps: float = 1e-5) -> Tensor:
    """x [N,Cin,H,W] float32 or bfloat16 (NCHW), conv weights in torch
    layout (w1 [Cmid,Cin,1,1], w2 [Cout,Cmid,1,1]) -> [N,Cout,H,W] in x's
    dtype. On the card one launch of K1 (its Cin x Cmid product on the
    tensor cores in 3xTF32), chosen by shape: Cin=16 (the ResNet34-flavour
    head, Cmid 128: one kernel, mma.sync) or Cin=64 (the ResNet50-flavour
    one, Cmid 512, on wgmma: the weight prep of :func:`wide_weight_images`
    on the BN-folded g1t, then the forward); any other shape raises (see
    :func:`_kernel_width`). A bfloat16 x launches K1 bf16 (no weight
    prep) of its width: the narrow one (mma.sync bf16), or the wide one
    (Cmid up to 512, wgmma bf16)."""
    if x.device.type == 'cpu':
        return pf_head_fwd_plain(x, w1, b1, gamma, beta, w2, b2, mean, var,
                                 eps)
    bf16 = x.dtype == torch.bfloat16
    _cuda.check_cuda_tensor(x, 'x', 4, x.dtype if bf16 else torch.float32)
    n, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    width = _kernel_width(cin, cmid, cout, bf16)
    if not width or w1.reshape(cmid, -1).shape[1] != cin:
        raise ValueError(f'the PF-head kernels take {_WIDTHS}; got '
                         f'{x.dtype} x {tuple(x.shape)}, w1 '
                         f'{tuple(w1.shape)}, w2 {tuple(w2.shape)}')
    g1t, c1 = fold_bn(w1, b1, gamma, beta, mean, var, eps)
    g1t = g1t.float().contiguous()
    c1 = c1.float().contiguous()
    w2m = w2.reshape(cout, cmid).float().contiguous()
    b2c = b2.float().contiguous()
    for name, t in (('g1t', g1t), ('c1', c1), ('w2', w2m), ('b2', b2c)):
        _cuda.check_cuda_tensor(t, name, t.dim())
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    # The wide float32 kernel splits g1t into its weight images first.
    img = (_wide_image_scratch(cmid, x.device),) if (
        width == 'wide' and not bf16) else ()
    lib = _cuda.library('fused_head', _SIGNATURES)
    stream = _cuda.stream_ptr(x.device.index)
    entry = {'narrow': 'pf_head_fwd', 'wide': 'pf_head_fwd_wide'}[width]
    entry += '_bf16' if bf16 else ''
    status = getattr(lib, entry)(x.data_ptr(), g1t.data_ptr(), c1.data_ptr(),
                                 w2m.data_ptr(), b2c.data_ptr(),
                                 out.data_ptr(), *(t.data_ptr() for t in img),
                                 n, cin, h * w, cmid, cout, stream)
    _cuda.check_status(status, entry)
    counter = _counter(width, bf16)
    setattr(fused_pf_head_fwd, counter,
            getattr(fused_pf_head_fwd, counter) + 1)
    return out


def pf_head_bwd_plain(x: Tensor, g: Tensor, w1t: Tensor, gis: Tensor,
                      c1: Tensor, w2gis: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain-torch version of the backward pass's arithmetic.

    x [N,Cin,H,W], g [N,Cout,H,W], w1t [Cmid,Cin], gis/c1 [Cmid],
    w2gis [Cmid,Cout] -> (dx [N,Cin,H,W], m0 [Cmid,Cout], m1 [Cmid,Cout],
    db2 [Cout], dw1 [Cin,Cmid]) as defined in ``csrc/fused_head.cu``. At
    bfloat16 (x and g bf16): mid from bf16(w1t), e rounded to bf16 for dx
    and dw1, dx = bf16(bf16(w1) e) (``_bwd_kernel``); the sums float32."""
    dt = x.dtype
    n, cin, h, w = x.shape
    x3 = widen(x).reshape(n, cin, h * w)
    g3 = widen(g).reshape(n, g.shape[1], h * w)
    w1t = _rounded(w1t, dt)
    mid = torch.einsum('ck,nks->ncs', w1t, x3)
    mask = (gis[:, None] * mid + c1[:, None] > 0).to(x3.dtype)
    e = _rounded(mask * torch.einsum('co,nos->ncs', w2gis, g3), dt)
    dx = torch.einsum('ck,ncs->nks', w1t, e).reshape(x.shape).to(dt)
    m0 = torch.einsum('ncs,nos->co', mask, g3)
    m1 = torch.einsum('ncs,nos->co', mask * mid, g3)
    db2 = g3.sum(dim=(0, 2))
    dw1 = torch.einsum('nks,ncs->kc', x3, e)
    return dx, m0, m1, db2, dw1


def fused_pf_head_bwd(x: Tensor, g: Tensor, w1t: Tensor, gis: Tensor,
                      c1: Tensor, w2gis: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward pass (see :func:`pf_head_bwd_plain`); on the card one
    launch of K2 (its products on the tensor cores in 3xTF32) with its
    fixed-order reduction of the per-block sums. Takes Cin=16, Cmid=128
    (the ResNet34-flavour head: one kernel, mma.sync), or Cin=64 and Cmid
    a multiple of 128 (the ResNet50-flavour one, Cmid 512, on wgmma: the
    weight prep of :func:`wide_weight_images`, a dx kernel and a sums
    kernel over 128-channel chunks); Cout=2. Bfloat16 x and g launch K2
    bf16 of their width (no weight prep): the narrow one (Cin=16,
    Cmid=128, mma.sync bf16) or the wide one (Cin=64, Cmid a multiple of
    128 up to 512, wgmma bf16: a dx kernel and a sums kernel, as the
    float32 wide K2); dx bf16, the sums float32."""
    if x.device.type == 'cpu':
        return pf_head_bwd_plain(x, g, w1t, gis, c1, w2gis)
    bf16 = x.dtype == torch.bfloat16
    _cuda.check_cuda_tensor(x, 'x', 4, x.dtype if bf16 else torch.float32)
    _cuda.check_cuda_tensor(g, 'g', 4, x.dtype)
    n, cin, h, w = x.shape
    cmid, cout = w2gis.shape
    width = _kernel_width(cin, cmid, cout, bf16)
    if width == 'narrow' and cmid != 128:
        width = ''
    if not width or tuple(g.shape) != (n, cout, h, w) \
            or tuple(w1t.shape) != (cmid, cin):
        raise ValueError(f'the PF-head backward kernels take Cin=16, '
                         f'Cmid=128, or Cin=64 and Cmid a multiple of 128 up '
                         f'to {_MAX_CMID} ({_WIDE_BF16_MAX_CMID} at '
                         f'bfloat16), with Cout=2; got {x.dtype} x '
                         f'{tuple(x.shape)}, g {tuple(g.shape)}, w1t '
                         f'{tuple(w1t.shape)}, w2gis {tuple(w2gis.shape)}')
    for name, t in (('w1t', w1t), ('gis', gis), ('c1', c1),
                    ('w2gis', w2gis)):
        _cuda.check_cuda_tensor(t, name, t.dim())
    lib = _cuda.library('fused_head', _SIGNATURES)
    if width == 'narrow':
        entry = 'pf_head_bwd_bf16' if bf16 else 'pf_head_bwd'
        blocks = getattr(lib, entry + '_blocks')(n, h * w)
        cols = lib.pf_head_bwd_partial_cols()
    else:
        entry = 'pf_head_bwd_wide_bf16' if bf16 else 'pf_head_bwd_wide'
        blocks = lib.pf_head_bwd_wide_blocks(n, h * w, cmid)
        cols = wide_sums_cols(cin, cmid, cout)
    if blocks <= 0:
        raise RuntimeError(f'{entry}: no CUDA device')
    dx = torch.empty_like(x)
    partial = torch.empty((blocks * cols,), dtype=torch.float32,
                          device=x.device)
    sums = torch.empty((cols,), dtype=torch.float32, device=x.device)
    img = (_wide_image_scratch(cmid, x.device),) if (
        width == 'wide' and not bf16) else ()
    stream = _cuda.stream_ptr(x.device.index)
    status = getattr(lib, entry)(
        x.data_ptr(), g.data_ptr(), w1t.data_ptr(), gis.data_ptr(),
        c1.data_ptr(), w2gis.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        *(t.data_ptr() for t in img), sums.data_ptr(), n, cin, h * w, cmid,
        cout, blocks, stream)
    _cuda.check_status(status, entry)
    counter = _counter(width, bf16)
    setattr(fused_pf_head_bwd, counter,
            getattr(fused_pf_head_bwd, counter) + 1)
    dw1, m0, m1, db2 = torch.split(sums, [cin * cmid, cmid * cout,
                                          cmid * cout, cout])
    return (dx, m0.view(cmid, cout), m1.view(cmid, cout), db2,
            dw1.view(cin, cmid))


# Launches of the narrow (Cin 16) and the wide (Cin 64) kernels, float32
# and bfloat16, apart (see _counter).
for _fn in (fused_pf_head_fwd, fused_pf_head_bwd):
    _fn.launches = _fn.wide_launches = 0
    _fn.bf16_launches = _fn.wide_bf16_launches = 0


def pf_head_backward(x: Tensor, g: Tensor, w1: Tensor, b1: Tensor,
                     gamma: Tensor, beta: Tensor, w2: Tensor, mean: Tensor,
                     var: Tensor, eps: float, train_stats: bool,
                     moments=fused_pf_head_bwd):
    """Gradients (dx, dw1, db1, dgamma, dbeta, dw2, db2) of the head for
    the output cotangent g, in the layouts of the inputs (torch conv
    weights). With ``train_stats`` the statistics are the batch's own and
    the result is the full batch-statistics BN backward
    (ref: bihome_tpu/ops/fused_head.py:205-270). dx is in x's dtype, the
    others float32. ``moments`` computes the
    one-pass sums (the K2 wrapper; :func:`pf_head_bwd_plain` to hold the
    kernel against the plain version on the card)."""
    dt = x.dtype
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
        # At bf16: a_mat rounded, dx rounded again (``_run_bwd:257-266``).
        a_mat = (w1f * k1[None, :]) @ w1f.t()                     # [Cin,Cin]
        x3 = widen(x).reshape(n, cin, -1)
        sx = x3.sum(dim=(0, 2))
        sxx = torch.matmul(x3, x3.transpose(1, 2)).sum(0)
        corr = torch.matmul(_rounded(a_mat, dt), x3).reshape(x.shape)
        dx = (widen(dx) - corr + (w1f @ k0)[None, :, None, None]).to(dt)
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
