"""The biHomE / CA-UDHN double-line triplet loss tail with its hand-written
backward (counterpart of ``bihome_tpu/ops/fused_loss.py``).

Over [B,h,w,C] feature maps (NHWC, the JAX layout):

    l1 = |f1' - f2|,  l2 = |f2' - f1|,  l3 = |f1 - f2|
    lm_i = hinge-aggregate(l_i, l3, margin, aggregation)      # [B,h,w]
    ln_i = sum_b sum_pix(w_i * lm_i) / max(sum_pix w_i, 1)

plus eight metric scalars. In JAX this is an XLA custom VJP, not a Pallas
kernel, so here it is plain torch in a ``torch.autograd.Function`` whose
backward is the same formula as ``fused_loss.py:128-195``:

* margin: a float, or the string 'inf' (no hinge). With
  ``second_scale=True`` a channel-agnostic float margin is multiplied by C
  for the second direction only (the reference's quirk,
  PerceptualHead.py:647-649).
* ``plain_grad=False`` treats f_plain = [f1; f2] as a constant (biHomE);
  True also returns its cotangent (the CA-UDHN tail).
* the hinge's subgradient is ``t > 0`` (0 at the kink);
* the metrics carry no gradient.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Tensor = torch.Tensor


def _hinge(l_pos: Tensor, l3: Tensor, margin, aggregation: str,
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


class TripletDoubleLine(torch.autograd.Function):
    """``apply(fp_w, f_plain, w1, w2, margin, aggregation, second_scale,
    plain_grad)`` -> (ln1, ln2, *metrics); see :func:`triplet_double_line`."""

    @staticmethod
    def forward(ctx, fp_w, f_plain, w1, w2, margin, aggregation,
                second_scale, plain_grad):
        b = fp_w.shape[0] // 2
        f1p, f2p = fp_w[:b], fp_w[b:]
        f1, f2 = f_plain[:b], f_plain[b:]
        l1 = (f1p - f2).abs()
        l2 = (f2p - f1).abs()
        l3 = (f1 - f2).abs()
        _, lm1 = _hinge(l1, l3, margin, aggregation, False)
        _, lm2 = _hinge(l2, l3, margin, aggregation, second_scale)
        den1 = w1.sum(dim=(-2, -1))
        den2 = w2.sum(dim=(-2, -1))
        ln1_b = (w1 * lm1).sum(dim=(-2, -1)) / den1.clamp_min(1.0)
        ln2_b = (w2 * lm2).sum(dim=(-2, -1)) / den2.clamp_min(1.0)
        metrics = (l1.mean(), l2.mean(), l3.mean(), f1.mean(), f2.mean(),
                   f1p.mean(), den1.min(), den2.min())
        ctx.save_for_backward(fp_w, f_plain, w1, w2, ln1_b, ln2_b, den1,
                              den2)
        ctx.cfg = (margin, aggregation, second_scale, plain_grad)
        ctx.mark_non_differentiable(*metrics)
        return (ln1_b.sum(), ln2_b.sum()) + metrics

    @staticmethod
    def backward(ctx, g1, g2, *_metric_grads):
        fp_w, f_plain, w1, w2, ln1_b, ln2_b, den1, den2 = ctx.saved_tensors
        margin, aggregation, second_scale, plain_grad = ctx.cfg
        b = fp_w.shape[0] // 2
        f1p, f2p = fp_w[:b], fp_w[b:]
        f1, f2 = f_plain[:b], f_plain[b:]
        den1e = den1.clamp_min(1.0)
        den2e = den2.clamp_min(1.0)
        e1 = f1p - f2
        e2 = f2p - f1
        e3 = f1 - f2
        l3 = e3.abs()
        h1, lm1 = _hinge(e1.abs(), l3, margin, aggregation, False)
        h2, lm2 = _hinge(e2.abs(), l3, margin, aggregation, second_scale)

        a1 = (g1 * w1 / den1e[:, None, None])[..., None]          # [B,h,w,1]
        a2 = (g2 * w2 / den2e[:, None, None])[..., None]
        s1 = torch.sign(e1)
        s2 = torch.sign(e2)
        d_fp = torch.cat([a1 * h1 * s1, a2 * h2 * s2], dim=0)
        d_plain = None
        if plain_grad:
            # l3 = |f1 - f2| enters both hinge terms with negative sign and
            # l2 = |f2' - f1| carries f1 directly.
            s3 = torch.sign(e3)
            d_f1 = -a1 * h1 * s3 - a2 * h2 * (s2 + s3)
            d_f2 = a1 * h1 * (s3 - s1) + a2 * h2 * s3
            d_plain = torch.cat([d_f1, d_f2], dim=0)
        # d/dw of sum(w*lm)/max(sum w, 1): the denominator's term flows only
        # where the clamp is inactive (den > 1).
        live1 = (den1 > 1.0).to(ln1_b.dtype)
        live2 = (den2 > 1.0).to(ln2_b.dtype)
        d_w1 = g1 * (lm1 - (ln1_b * live1)[:, None, None]) / \
            den1e[:, None, None]
        d_w2 = g2 * (lm2 - (ln2_b * live2)[:, None, None]) / \
            den2e[:, None, None]
        return d_fp, d_plain, d_w1, d_w2, None, None, None, None


def triplet_double_line(fp_w: Tensor, f_plain: Tensor, w1: Tensor,
                        w2: Tensor, margin: Union[float, str],
                        aggregation: str, second_scale: bool = True,
                        plain_grad: bool = False
                        ) -> Tuple[Tensor, Tensor, Tuple[Tensor, ...]]:
    """fp_w = [f1'; f2'] and f_plain = [f1; f2], each [2B,h,w,C]; w1, w2
    [B,h,w] mask products -> (ln1, ln2, metrics) with metrics = (mean l1,
    mean l2, mean l3, mean f1, mean f2, mean f1', min den1, min den2)."""
    out = TripletDoubleLine.apply(fp_w, f_plain, w1, w2, margin, aggregation,
                                  second_scale, plain_grad)
    return out[0], out[1], tuple(out[2:])
