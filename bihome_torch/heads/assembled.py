"""Backbone + head predict path (counterpart of
``bihome_tpu/heads/assembled.py:354-396,762-826``).

Ported: ``predict`` for PerceptualHead with one DSAC hypothesis and no
scoring — the zeng-biHomE eval chain: backbone perspective field ->
sampled points -> DLT -> corner deltas. Losses, scoring, refinement and the
bidirectional fit are not ported yet; configs that need them raise when
the model is built.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from bihome_torch import geometry
from bihome_torch.heads import dsac
from bihome_torch.heads.config import HeadConfig

Tensor = torch.Tensor


def check_ported(cfg: HeadConfig) -> None:
    """Raise for the head features this port does not have yet."""
    missing = []
    if cfg.name != 'PerceptualHead':
        missing.append(f'head {cfg.name!r}')
    if cfg.delta_hat_keys:
        missing.append('DELTA_HAT_KEYS (regression-backbone perceptual mode)')
    if cfg.hypothesis_no != 1:
        missing.append(f'RANSAC_HYPOTHESIS_NO={cfg.hypothesis_no}')
    if cfg.scoring_method == 'score_cnn':
        missing.append('score_cnn scoring')
    if cfg.dsac_predict_refine:
        missing.append('DSAC_PREDICT_REFINE')
    if cfg.dsac_predict_bidirectional:
        missing.append('DSAC_PREDICT_BIDIRECTIONAL')
    if missing:
        raise ValueError('not ported yet: ' + ', '.join(missing))


class AssembledModel(nn.Module):
    """The backbone plus the PerceptualHead predict chain."""

    def __init__(self, backbone: nn.Module, head: HeadConfig):
        super().__init__()
        check_ported(head)
        self.backbone = backbone
        self.head = head

    def dsac_deltas(self, pf: Tensor, uniforms: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        """PF [B,h,w,2] -> corner deltas [B,4,2] of the single DSAC
        hypothesis. With one hypothesis softmax(-score) is identically 1,
        so scoring is skipped, as in the JAX package."""
        cfg = self.head
        b, h, w, _ = pf.shape
        hyps = dsac.sample_hypotheses_from_pf(
            pf, cfg.hypothesis_no, cfg.points_per_hypothesis,
            cfg.dsac_point_sampling, uniforms, generator)          # [B,1,3,3]
        four_points = geometry.image_corners(h, w, batch_size=b,
                                             device=pf.device)
        transformed = geometry.transform_points(hyps[:, 0], four_points)
        return transformed - four_points

    @torch.inference_mode()
    def predict(self, batch: Dict[str, Tensor],
                uniforms: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """Batch dict (NHWC patches) -> delta_hat [B,4,2]. ``uniforms``
        [B, points_per_hypothesis] injects the DSAC draws; otherwise they
        come from ``generator``."""
        outputs = self.backbone(batch)
        return self.dsac_deltas(outputs[self.head.pf_keys[0]], uniforms,
                                generator)
