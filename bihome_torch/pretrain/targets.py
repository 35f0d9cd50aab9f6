"""The pure parts of the extractor's pretext training (counterpart of
``tools/pretrain_aux.py:75-270``), NHWC as there.

* :func:`grad_targets` / :func:`grad_targets_pi`: the distillation
  targets, a multi-scale intensity and Sobel pyramid (gradients only,
  contrast-normalised, for the photometric-invariant variant) at
  H/``stride``, through a FIXED random projection and tanh. The
  projections are JAX's ``jax.random.normal(PRNGKey(42 | 43), (k, out_dim))
  / sqrt(k)`` draws, kept in ``projections.npz`` beside this module (the
  port cannot call JAX; the file names the JAX version that made it, and
  ``tests/test_torch_pretrain_targets.py`` holds each matrix bit for bit
  to the installed JAX's call).
* :func:`dense_infonce`: the dense-correspondence InfoNCE between two
  aligned feature maps, both directions; :func:`basin_ratio`: the
  misalignment contrast of the basin term.
* :func:`warp_gt`: a patch warped by the ground-truth corner deltas as the
  biHomE loss warps by delta_hat, through ``geometry.batched_sample`` (K3
  on the card), with its closed-form support mask.

Every 3x3 filter pads by replicating the edge (:func:`conv3_edge`), so a
constant offset gives sum(k) * offset everywhere and the Sobel channels
of ``grad_targets_pi`` do not see a brightness offset.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bihome_torch import geometry

Tensor = torch.Tensor

_KX = ((1., 0., -1.), (2., 0., -2.), (1., 0., -1.))        # / 4: Sobel x
_KD = ((2., 1., 0.), (1., 0., -1.), (0., -1., -2.))        # / 4: 45 degrees
_KL = ((0., 1., 0.), (1., -4., 1.), (0., 1., 0.))          # / 4: Laplacian
_BINOMIAL = ((1., 2., 1.), (2., 4., 2.), (1., 2., 1.))     # / 16
# Blur passes of the pyramid's four scales (sigma ~ 0, 1, 2, 4 px).
_SCALES = (0, 2, 8, 32)
_PROJECTIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'projections.npz')


@functools.lru_cache(maxsize=None)
def _projection_table():
    with np.load(_PROJECTIONS) as data:
        return {k: data[k] for k in data.files}


def projection(name: str, k: int, out_dim: int, device=None) -> Tensor:
    """The fixed [k, out_dim] float32 projection of ``name`` ('grad':
    PRNGKey(42), 'gradpi': PRNGKey(43)), on ``device``."""
    table = _projection_table()
    key = f'{name}_{k}x{out_dim}'
    if key not in table:
        raise ValueError(f'no {name} projection of {k} channels to '
                         f'{out_dim}: the pretext trains layer 1 (64) or 2 '
                         f'(128)')
    return torch.from_numpy(table[key]).to(device)


def _kernel(rows, scale: float, like: Tensor) -> Tensor:
    return torch.tensor(rows, dtype=like.dtype, device=like.device) / scale


def conv3_edge(x: Tensor, k: Tensor) -> Tensor:
    """The 3x3 filter ``k`` on every channel of x [B,H,W,C] (a depthwise
    cross-correlation), over the edge-replicated image (``_conv3_edge``
    and ``_sobel``, ``pretrain_aux.py:75-88``)."""
    c = x.shape[-1]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode='replicate')
    w = k.reshape(1, 1, 3, 3).expand(c, 1, 3, 3)
    return F.conv2d(xp, w, groups=c).permute(0, 2, 3, 1)


def blur(x: Tensor, times: int) -> Tensor:
    """``times`` passes of the 3x3 binomial blur (``_blur``)."""
    k = _kernel(_BINOMIAL, 16.0, x)
    for _ in range(times):
        x = conv3_edge(x, k)
    return x


def nnavg_pool(x: Tensor, s: int) -> Tensor:
    """Mean over s x s cells: [B,H,W,C] -> [B,H/s,W/s,C]."""
    b, h, w, c = x.shape
    return x.reshape(b, h // s, s, w // s, s, c).mean(dim=(2, 4))


def _pyramid(x: Tensor, stride: int, intensity: bool, rich: bool
             ) -> Tensor:
    """The channels of the pyramid at H/``stride``, in JAX's order: per
    scale the (blurred) intensity if ``intensity``, its x and y Sobel, and
    with ``rich`` the two diagonal derivatives and the Laplacian."""
    x = x.float()
    kx, kd, kl = (_kernel(k, 4.0, x) for k in (_KX, _KD, _KL))
    base = nnavg_pool(x, stride)
    chans = []
    for times in _SCALES:
        b = blur(base, times) if times else base
        chans += ([b] if intensity else []) + [conv3_edge(b, kx),
                                               conv3_edge(b, kx.T)]
        if rich:
            chans += [conv3_edge(b, kd), conv3_edge(b, kd.T),
                      conv3_edge(b, kl)]
    return torch.cat(chans, dim=-1)


def grad_targets(x: Tensor, rich: bool = False, stride: int = 4,
                 out_dim: int = 64) -> Tensor:
    """``grad_targets`` (``pretrain_aux.py:101-138``): x [B,H,W,1] ->
    tanh(pyramid @ projection) [B,H/stride,W/stride,out_dim]; 12 channels,
    24 with ``rich``. stride 4 / out_dim 64 match layer1 features, 8 / 128
    layer2."""
    t = _pyramid(x, stride, intensity=True, rich=rich)
    return torch.tanh(t @ projection('grad', t.shape[-1], out_dim, t.device))


def grad_targets_pi(x: Tensor, stride: int = 4, out_dim: int = 64
                    ) -> Tensor:
    """``grad_targets_pi`` (``:146-165``): the 8 gradient channels divided
    by each sample's mean |channel| (+ 1e-3), then the projection and
    tanh."""
    t = _pyramid(x, stride, intensity=False, rich=False)
    t = t / (t.abs().mean(dim=(1, 2, 3), keepdim=True) + 1e-3)
    return torch.tanh(t @ projection('gradpi', t.shape[-1], out_dim,
                                     t.device))


def _neighbours(hf: int, wf: int, rex: int, device) -> Tensor:
    """[P,P] True where two grid positions lie within Chebyshev radius
    ``rex`` of each other and apart."""
    ii, jj = torch.meshgrid(torch.arange(hf, device=device),
                            torch.arange(wf, device=device), indexing='ij')
    pos = torch.stack([ii.reshape(-1), jj.reshape(-1)], dim=-1)
    cheb = (pos[:, None, :] - pos[None, :, :]).abs().amax(dim=-1)
    return (cheb <= rex) & (cheb > 0)


def _masked_lse(x: Tensor, mask: Tensor) -> Tensor:
    return torch.logsumexp(torch.where(mask, x, torch.full_like(x, -1e9)),
                           dim=-1)


def dense_infonce(f1: Tensor, f2: Tensor, valid: Tensor, tau: float = 0.15,
                  rex: int = 2, hard_beta: float = 0.0
                  ) -> Tuple[Tensor, Tensor]:
    """``dense_infonce`` (``:168-238``): f1, f2 [B,Hf,Wf,C] aligned, valid
    [B,Hf,Wf] -> (loss, acc), each the mean of the two directions. Per
    sample the cosine similarities of every position of one map with
    every position of the other, over ``tau``; the positive is the same
    position; the neighbours within Chebyshev ``rex`` and the candidates
    without full support (valid < 0.999) leave the denominator (-1e9);
    anchors without full support count for nothing. ``hard_beta`` > 0
    reweights the negatives by softmax(beta s): log N + lse((1+beta)s) -
    lse(beta s) for the negatives' term. The similarity is one batched
    product, [B,P,P] float32."""
    b, hf, wf, c = f1.shape
    p = hf * wf
    n1 = f1.reshape(b, p, c).float()
    n2 = f2.reshape(b, p, c).float()
    n1 = n1 / (torch.linalg.vector_norm(n1, dim=-1, keepdim=True) + 1e-6)
    n2 = n2 / (torch.linalg.vector_norm(n2, dim=-1, keepdim=True) + 1e-6)
    sim = torch.bmm(n1, n2.transpose(1, 2)) / tau                 # [B,P,P]

    eye = torch.eye(p, dtype=torch.bool, device=f1.device)
    vflat = valid.reshape(b, p)
    w = (vflat > 0.999).float()                                   # anchors
    excl = ((_neighbours(hf, wf, rex, f1.device)[None]
             | (vflat[:, None, :] < 0.999)) & ~eye[None])
    neg_mask = ~excl & ~eye[None]
    positions = torch.arange(p, device=f1.device)

    def one_dir(s):
        lg = torch.where(excl, torch.full_like(s, -1e9), s)
        diag = torch.diagonal(lg, dim1=1, dim2=2)
        if hard_beta > 0.0:
            n_neg = neg_mask.sum(dim=-1).float()
            log_neg = (torch.log(n_neg + 1e-6)
                       + _masked_lse((1.0 + hard_beta) * s, neg_mask)
                       - _masked_lse(hard_beta * s, neg_mask))
            lse = torch.logaddexp(diag, log_neg)
        else:
            lse = torch.logsumexp(lg, dim=-1)
        denom = w.sum() + 1e-6
        loss = ((lse - diag) * w).sum() / denom
        hits = (lg.argmax(dim=-1) == positions[None]).float()
        acc = (hits * w).sum() / denom
        return loss, acc

    la, aa = one_dir(sim)
    lb, ab = one_dir(sim.transpose(1, 2))
    return 0.5 * (la + lb), 0.5 * (aa + ab)


def basin_ratio(fw1: Tensor, fw1e: Tensor, f2: Tensor, valid: Tensor,
                valide: Tensor) -> Tensor:
    """``basin_ratio`` (``:241-257``): mean over samples of (d_eps - d_0) /
    (d_eps + d_0 + 1e-6), d the mean |feature difference| to ``f2`` over
    the positions both views fully support."""
    w = ((valid > 0.999) & (valide > 0.999)).float()
    wsum = w.sum(dim=(1, 2)) + 1e-6

    def mdist(fa):
        d = (fa - f2).abs().mean(dim=-1)                          # [B,Hf,Wf]
        return (d * w).sum(dim=(1, 2)) / wsum

    d0, de = mdist(fw1), mdist(fw1e)
    return ((de - d0) / (de + d0 + 1e-6)).mean()


def warp_gt(patch: Tensor, delta: Tensor) -> Tuple[Tensor, Tensor]:
    """``warp_gt`` (``:260-270``): patch [B,H,W,C] warped by the homography
    of its own corners and ``delta`` [B,4,2] (``geometry.batched_sample``,
    K3 on the card), and the closed-form support mask [B,H,W,1]."""
    b, h, w = patch.shape[:3]
    corners = geometry.image_corners(h, w, batch_size=b, device=patch.device)
    homography = geometry.four_point_to_homography(corners, delta.float())
    u, v = geometry.homography_grid(homography, (h, w))
    warped = geometry.batched_sample(patch, u, v).reshape(patch.shape)
    mask = geometry.ones_warp_mask(u, v, (h, w)).reshape(b, h, w, 1)
    return warped, mask
