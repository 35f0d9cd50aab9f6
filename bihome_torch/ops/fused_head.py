"""Perspective-field head forward: 1x1 conv -> BN -> ReLU -> 1x1 conv.

``fused_pf_head_fwd`` is the counterpart of
``bihome_tpu/ops/fused_head.py:fused_pf_head`` in eval mode (the TPU kernel
``_fwd_kernel`` driven by ``_run_fwd``). It reads the backbone's NCHW
activation directly and returns NCHW. BN is folded into the first conv
here, as ``_run_fwd`` does it; the statistics are inputs so a training
slice can pass batch statistics. A CPU tensor takes
:func:`pf_head_fwd_plain`; a CUDA tensor launches ``csrc/fused_head.cu``
(see its header for the H100 bound and design) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bihome_torch.ops import _cuda

_SIGNATURES = {'pf_head_fwd': [ctypes.c_void_p] * 6
               + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def fold_bn(w1: torch.Tensor, b1: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g1t [Cmid,Cin], c1 [Cmid]) with relu(BN(w1 x + b1)) ==
    relu(g1t x + c1) (ref: bihome_tpu/ops/fused_head.py:180-184)."""
    cmid = w1.shape[0]
    gis = gamma * torch.rsqrt(var + eps)
    g1t = w1.reshape(cmid, -1) * gis[:, None]
    c1 = (b1 - mean) * gis + beta
    return g1t, c1


def pf_head_fwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain-torch version of the same folded arithmetic; materializes the
    [N,Cmid,H,W] middle. x [N,Cin,H,W] -> [N,Cout,H,W]."""
    g1t, c1 = fold_bn(w1, b1, gamma, beta, mean, var, eps)
    a = torch.einsum('jk,nkhw->njhw', g1t, x) + c1[:, None, None]
    w2m = w2.reshape(w2.shape[0], -1)
    return (torch.einsum('oj,njhw->nohw', w2m, torch.relu(a))
            + b2[:, None, None])


def fused_pf_head_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
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


fused_pf_head_fwd.launches = 0
