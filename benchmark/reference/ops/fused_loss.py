"""The biHomE / CA-UDHN double-line triplet loss tail in plain torch.

Over [B,h,w,C] feature maps (NHWC):

    l1 = |f1' - f2|,  l2 = |f2' - f1|,  l3 = |f1 - f2|
    lm_i = hinge-aggregate(l_i, l3, margin, aggregation)      # [B,h,w]
    ln_i = sum_b sum_pix(w_i * lm_i) / max(sum_pix w_i, 1)

plus eight metric scalars, which carry no gradient. margin: a float, or
the string 'inf' (no hinge); with ``second_scale=True`` a
channel-agnostic float margin is multiplied by C for the second
direction only (the reference's quirk, PerceptualHead.py:647-649).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from benchmark.reference.models.layers import widen

Tensor = torch.Tensor


def hinge_aggregate(l_pos: Tensor, l3: Tensor, margin, aggregation: str,
                    second: bool) -> Tuple[Tensor, Tensor]:
    """-> (hinge mask broadcastable to [.,h,w,C], loss mat [.,h,w])."""
    if isinstance(margin, str):                       # 'inf': no hinge
        return torch.ones((), dtype=l_pos.dtype, device=l_pos.device), \
            (l_pos - l3).sum(-1)
    if aggregation == 'channel-aware':
        t = l_pos - l3 + margin
        return (t > 0).to(l_pos.dtype), t.clamp_min(0.0).sum(-1)
    if aggregation == 'channel-agnostic':
        eff = margin * l_pos.shape[-1] if second else margin
        t = l_pos.sum(-1) - l3.sum(-1) + eff
        return (t > 0).to(l_pos.dtype)[..., None], t.clamp_min(0.0)
    raise ValueError(aggregation)


def triplet_double_line(fp_w: Tensor, f_plain: Tensor, w1: Tensor,
                        w2: Tensor, margin: Union[float, str],
                        aggregation: str, second_scale: bool = True,
                        plain_grad: bool = False
                        ) -> Tuple[Tensor, Tensor, Tuple[Tensor, ...]]:
    """fp_w = [f1'; f2'] and f_plain = [f1; f2], each [2B,h,w,C]; w1, w2
    [B,h,w] mask products -> (ln1, ln2, metrics) with metrics = (mean l1,
    mean l2, mean l3, mean f1, mean f2, mean f1', min den1, min den2).
    Gradients by autograd; ``plain_grad=False`` holds f_plain constant."""
    if not plain_grad:
        f_plain = f_plain.detach()
    b = fp_w.shape[0] // 2
    f1p, f2p = widen(fp_w[:b]), widen(fp_w[b:])
    f1, f2 = widen(f_plain[:b]), widen(f_plain[b:])
    w1f, w2f = widen(w1), widen(w2)
    l1 = (f1p - f2).abs()
    l2 = (f2p - f1).abs()
    l3 = (f1 - f2).abs()
    _, lm1 = hinge_aggregate(l1, l3, margin, aggregation, False)
    _, lm2 = hinge_aggregate(l2, l3, margin, aggregation, second_scale)
    den1 = w1f.sum(dim=(-2, -1))
    den2 = w2f.sum(dim=(-2, -1))
    ln1 = ((w1f * lm1).sum(dim=(-2, -1)) / den1.clamp_min(1.0)).sum()
    ln2 = ((w2f * lm2).sum(dim=(-2, -1)) / den2.clamp_min(1.0)).sum()
    with torch.no_grad():
        metrics = (l1.mean(), l2.mean(), l3.mean(), f1.mean(), f2.mean(),
                   f1p.mean(), den1.min(), den2.min())
    return ln1, ln2, metrics
