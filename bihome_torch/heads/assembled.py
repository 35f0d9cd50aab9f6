"""Backbone + PerceptualHead: the predict chain and the biHomE training
loss (counterpart of ``bihome_tpu/heads/assembled.py``).

Ported:

* ``predict`` for PerceptualHead with one DSAC hypothesis and no scoring —
  the zeng-biHomE eval chain: backbone perspective field -> sampled points
  -> DLT -> corner deltas (``assembled.py:354-396,762-826``).
* ``forward`` (the training loss, ``_perceptual_forward`` and
  ``_triplet_resnet_loss``, ``:330-728``) for the double-line, mask-less,
  l1, downsample-mask biHomE variant of every shipped ``*-bihome`` config:
  DSAC in both directions with gradients flowing, one warp of both
  patches with the closed-form support mask, the frozen extractor run
  twice (plain patches without gradient, warped patches with input
  gradients), the fused triplet tail and the ``TRIPLET_MU`` homography
  consistency term, plus the metrics of ``:652-725`` under the same keys.

Other heads and variants raise ``not ported yet``. The auxiliary extractor
is frozen: its parameters never require grad and it stays in eval mode
(``auxiliary_resnet_bn_train`` False, ``heads/config.py:40``) even when
the model is put in training mode.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bihome_torch import geometry
from bihome_torch.heads import dsac
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models.resnet import ResNet
from bihome_torch.ops import fused_loss

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


def check_trainable(cfg: HeadConfig) -> None:
    """Raise for the loss variants the training forward does not have."""
    missing = []
    if cfg.triplet_loss != 'double-line':
        missing.append(f'TRIPLET_LOSS {cfg.triplet_loss!r}')
    if cfg.mask_keys:
        missing.append('MASK_KEYS')
    if cfg.triplet_distance != 'l1':
        missing.append(f'TRIPLET_DISTANCE {cfg.triplet_distance!r}')
    if cfg.sampling_strategy != 'downsample-mask':
        missing.append(f'SAMPLING_STRATEGY {cfg.sampling_strategy!r}')
    if cfg.with_projection_head:
        missing.append('WITH_PROJECTION_HEAD')
    if not cfg.auxiliary_resnet_freeze:
        missing.append('AUXILIARY_RESNET_FREEZE false')
    if cfg.auxiliary_resnet_bn_train:
        missing.append('AUXILIARY_RESNET_BN_TRAIN')
    if len(cfg.pf_keys) != 2:
        missing.append('a one-line backbone')
    if missing:
        raise ValueError('not ported yet: ' + ', '.join(missing))


class AssembledModel(nn.Module):
    """The backbone plus the PerceptualHead (predict chain and loss)."""

    def __init__(self, backbone: nn.Module, head: HeadConfig):
        super().__init__()
        check_ported(head)
        self.backbone = backbone
        self.head = head
        self.auxiliary_resnet = ResNet(
            arch=head.auxiliary_resnet,
            output_layer=head.auxiliary_resnet_output_layer)
        self.auxiliary_resnet.requires_grad_(False)
        self.auxiliary_resnet.eval()

    def train(self, mode: bool = True) -> 'AssembledModel':
        super().train(mode)
        self.auxiliary_resnet.eval()      # frozen, eval-mode BN always
        return self

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
                                             dtype=pf.dtype, device=pf.device)
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

    def aux_features(self, x: Tensor) -> Tensor:
        """Frozen-extractor features of NHWC patches, returned NHWC (a view
        of the NCHW maps)."""
        nchw = x.permute(0, 3, 1, 2).contiguous()
        return self.auxiliary_resnet(nchw).permute(0, 2, 3, 1)

    def forward(self, batch: Dict[str, Tensor],
                uniforms: Optional[Sequence[Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        """The biHomE training loss. ``uniforms`` = (12 draws, 21 draws),
        each [B, points_per_hypothesis], injects the DSAC draws of the two
        directions; otherwise both come from ``generator``, 12 first.
        -> {'loss', 'delta_gt', 'delta_hat', 'metrics'}."""
        check_trainable(self.head)
        outputs = self.backbone(batch)
        delta_12, delta_21 = self.dsac_both(outputs, uniforms, generator)
        return self.bihome_loss(batch, delta_12, delta_21)

    def dsac_both(self, outputs: Dict[str, Tensor],
                  uniforms: Optional[Sequence[Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
        """(delta_12, delta_21) [B,4,2] from the two perspective fields,
        the 1->2 direction's draws first."""
        cfg = self.head
        u12, u21 = uniforms if uniforms is not None else (None, None)
        return (self.dsac_deltas(outputs[cfg.pf_keys[0]], u12, generator),
                self.dsac_deltas(outputs[cfg.pf_keys[1]], u21, generator))

    def bihome_loss(self, batch: Dict[str, Tensor], delta_12: Tensor,
                    delta_21: Tensor) -> Dict[str, object]:
        """The biHomE double-line loss for the corner deltas of both
        directions (``_triplet_resnet_loss``, ``assembled.py:482-728``)."""
        cfg = self.head
        e1, e2 = cfg.patch_keys
        patch_1, patch_2 = batch[e1], batch[e2]
        b, ps = patch_1.shape[0], patch_1.shape[1]

        # One warp of both patches; the warped all-ones mask in closed form
        # (ref: assembled.py:121-135, 511-525).
        both = torch.cat([patch_1, patch_2], dim=0)
        corners = geometry.image_corners(ps, ps, batch_size=2 * b,
                                         dtype=both.dtype, device=both.device)
        hom = geometry.four_point_to_homography(
            corners, torch.cat([delta_12, delta_21], dim=0))
        u, v = geometry.homography_grid(hom, (ps, ps))
        warped = geometry.batched_sample(both, u, v).reshape(both.shape)
        wmask = geometry.ones_warp_mask(u, v, (ps, ps)).reshape(2 * b, 1,
                                                                ps, ps)
        h1, h2 = hom[:b], hom[b:]

        # The plain patches are data: their features carry no gradient. The
        # warped pass carries input gradients into the warp only (the
        # extractor's parameters never require grad).
        with torch.no_grad():
            feats_plain = self.aux_features(both)
        feats_w = self.aux_features(warped)
        factor = ps // feats_w.shape[1]
        # Mask downsampling to feature resolution (ref: assembled.py:582-
        # 587); the unwarped masks are all ones and stay ones.
        wmask_d = F.avg_pool2d(wmask, factor)[:, 0]
        m1p_sq, m2p_sq = wmask_d[:b], wmask_d[b:]
        ln1, ln2, fm = fused_loss.triplet_double_line(
            feats_w, feats_plain, m1p_sq, m2p_sq, cfg.triplet_margin,
            cfg.triplet_aggregation, True, False)
        eye = torch.eye(3, dtype=h1.dtype, device=h1.device)
        ln3 = ((h1 @ h2 - eye) ** 2).sum()
        loss = ln1 + ln2 + cfg.triplet_mu * ln3
        (mean_l1, mean_l2, mean_l3, mean_f1, mean_f2, mean_f1p, min_den1,
         min_den2) = fm
        with torch.no_grad():
            metrics = {'loss_comp/ln1': ln1.detach(),
                       'loss_comp/ln2': ln2.detach(),
                       'loss_comp/ln3': cfg.triplet_mu * ln3,
                       'loss_den/l1_den': min_den1,
                       'loss_den/l2_den': min_den2,
                       'loss_comp/l2': mean_l2,
                       'h/h2': ((h2 - eye) ** 2).sum(),
                       'feature_space/patch_1_f': mean_f1,
                       'feature_space/patch_2_f': mean_f2,
                       'feature_space/patch_1_f_prime': mean_f1p,
                       'loss_comp/l1': mean_l1,
                       'loss_comp/l3': mean_l3,
                       'h/h1': ((h1 - eye) ** 2).sum()}
        return {'loss': loss, 'delta_gt': batch.get('delta'),
                'delta_hat': delta_12, 'metrics': metrics}
