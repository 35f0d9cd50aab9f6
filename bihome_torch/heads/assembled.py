"""Backbone + head: the predict chain and the training forward
(counterpart of ``bihome_tpu/heads/assembled.py``).

Ported heads:

* ``NoOpHead`` (``assembled.py:166-184``) with '4_points': the backbone's
  corner deltas against the ground truth under a tensor loss; with
  'all_points' (zeng-orig): the perspective field against the PF target,
  its corner readout as delta_hat, and at predict the RANSAC fit of the
  field (:mod:`bihome_torch.heads.ransac`, ``:768-776``).
* ``PhotometricHead`` (``:188-208``): warp-then-crop of the full
  ``image_1`` by the homography of the predicted deltas, sampled directly
  at the patch grid offset to the patch corner, against ``patch_2`` under
  a tensor loss.
* ``PerceptualHead`` with one DSAC hypothesis and no scoring (zeng-biHomE:
  backbone perspective fields -> sampled points -> DLT -> corner deltas,
  ``:354-396``; at predict the all-points refit DSAC_PREDICT_REFINE and
  the average with the inverted 2->1 fit DSAC_PREDICT_BIDIRECTIONAL,
  ``:790-826``), or with ``DELTA_HAT_KEYS`` (detone-biHomE: the
  regression backbone's deltas of both directions, n = 1, ``:336-340``).
  Its training forward is the double-line, mask-less, l1, downsample-mask
  biHomE loss of every shipped ``*-bihome`` config (``_triplet_resnet_loss``,
  ``:482-728``): one warp of both patches with the closed-form support
  mask, the frozen extractor run twice (plain patches without gradient,
  warped patches with input gradients), the fused triplet tail and the
  ``TRIPLET_MU`` homography consistency term, plus the metrics of
  ``:652-725`` under the same keys.
* ``TripletHead`` (Zhang et al.'s CA-UDHN loss, ``:212-326``): both
  patches warped by the predicted deltas, the support mask in closed form
  under FIX_MASK (else the predicted masks warped too), the backbone's
  feature extractor re-run in the model's mode on each warped patch, the
  fused triplet tail with learned features on both sides (DoubleLine) or
  the open-coded one-line loss, and the ``MU`` consistency term.
* ``predict`` for all four (``:762-826``).

``forward`` returns the JAX keys: ``{'ground_truth', 'network_output',
'delta_gt', 'delta_hat', 'metrics'}`` for the tensor-loss heads, ``{'loss',
'delta_gt', 'delta_hat', 'metrics'}`` for the biHomE loss. Other heads and
variants raise ``not ported yet``. The PerceptualHead's auxiliary
extractor is frozen: its parameters never require grad and it stays in
eval mode (``auxiliary_resnet_bn_train`` False, ``heads/config.py:40``)
even when the model is put in training mode.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bihome_torch import geometry
from bihome_torch.heads import dsac, ransac
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models.layers import cast
from bihome_torch.models.resnet import ResNet
from bihome_torch.ops import fused_loss

Tensor = torch.Tensor


def needs_dsac(cfg: HeadConfig) -> bool:
    """Whether the head draws DSAC points (``bihome_tpu/config.py:81-84``)."""
    return cfg.name == 'PerceptualHead' and not cfg.delta_hat_keys


def needs_ransac(cfg: HeadConfig) -> bool:
    """Whether predict fits the perspective field by RANSAC (the NoOp
    'all_points' head, ``bihome_tpu/heads/assembled.py:768-776``)."""
    return cfg.name == 'NoOpHead' and cfg.target_gen == 'all_points'


def check_ported(cfg: HeadConfig) -> None:
    """Raise for the head features this port does not have yet."""
    missing = []
    if cfg.name not in ('NoOpHead', 'PhotometricHead', 'PerceptualHead',
                        'TripletHead'):
        missing.append(f'head {cfg.name!r}')
    if cfg.name == 'NoOpHead' and cfg.target_gen not in ('4_points',
                                                         'all_points'):
        missing.append(f'NoOpHead TARGET_GEN {cfg.target_gen!r}')
    if needs_dsac(cfg):
        if cfg.hypothesis_no != 1:
            missing.append(f'RANSAC_HYPOTHESIS_NO={cfg.hypothesis_no}')
        if cfg.scoring_method == 'score_cnn':
            missing.append('score_cnn scoring')
    if missing:
        raise ValueError('not ported yet: ' + ', '.join(missing))


def check_trainable(cfg: HeadConfig) -> None:
    """Raise for the biHomE loss variants the training forward does not
    have (the tensor-loss heads have none)."""
    if cfg.name != 'PerceptualHead':
        return
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
    if len(cfg.delta_hat_keys or cfg.pf_keys) != 2:
        missing.append('a one-line backbone')
    if missing:
        raise ValueError('not ported yet: ' + ', '.join(missing))


class AssembledModel(nn.Module):
    """The backbone plus its head (predict chain and training forward).
    ``compute_dtype`` (set with the backbone's by ``build_model``) is the
    dtype the biHomE loss casts its patches and warped masks to, as
    ``assembled.py:503-530`` does; None at float32."""

    compute_dtype = None

    def __init__(self, backbone: nn.Module, head: HeadConfig):
        super().__init__()
        check_ported(head)
        self.backbone = backbone
        self.head = head
        self.auxiliary_resnet = None
        if head.name == 'PerceptualHead':
            self.auxiliary_resnet = ResNet(
                arch=head.auxiliary_resnet,
                output_layer=head.auxiliary_resnet_output_layer)
            self.auxiliary_resnet.requires_grad_(False)
            self.auxiliary_resnet.eval()

    def train(self, mode: bool = True) -> 'AssembledModel':
        super().train(mode)
        if self.auxiliary_resnet is not None:
            self.auxiliary_resnet.eval()  # frozen, eval-mode BN always
        return self

    @property
    def draws_on_device(self) -> bool:
        """Whether predict's draws are made on the field's device (RANSAC's
        point indices) rather than on the CPU (DSAC's uniforms)."""
        return needs_ransac(self.head)

    def dsac_deltas(self, pf: Tensor, uniforms: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        """PF [B,h,w,2] -> corner deltas [B,4,2] of the single DSAC
        hypothesis. With one hypothesis softmax(-score) is identically 1,
        so scoring is skipped, as in the JAX package. A bfloat16 field
        gives float32 deltas, as ``assembled.py:391-395`` does."""
        cfg = self.head
        b, h, w, _ = pf.shape
        hyps = dsac.sample_hypotheses_from_pf(
            pf, cfg.hypothesis_no, cfg.points_per_hypothesis,
            cfg.dsac_point_sampling, uniforms, generator)          # [B,1,3,3]
        four_points = geometry.image_corners(h, w, batch_size=b,
                                             dtype=hyps.dtype,
                                             device=pf.device)
        transformed = geometry.transform_points(hyps[:, 0], four_points)
        return transformed - four_points

    @torch.inference_mode()
    def predict(self, batch: Dict[str, Tensor],
                uniforms=None,
                generator: Optional[torch.Generator] = None,
                idx: Optional[Tensor] = None) -> Tensor:
        """Batch dict (NHWC patches) -> delta_hat [B,4,2]
        (``bihome_tpu/heads/assembled.py:762-826``): the backbone's deltas,
        the DSAC fit of its perspective field (:meth:`fit_delta`), or (NoOp
        'all_points') the RANSAC fit of the field, whose point indices
        ``idx`` [B, 4K] injects. With DSAC_PREDICT_BIDIRECTIONAL the 2->1
        field is fitted too, inverted through the corner parametrization
        (H12 = H21^-1) and averaged with the 1->2 fit. ``uniforms``
        injects the DSAC draws, [B, points_per_hypothesis] for the 1->2
        field or a sequence (1->2[, 2->1]); the draws it does not give
        come from ``generator``, the 1->2 field's first (RANSAC draws on
        the field's device, so its generator lives there)."""
        cfg = self.head
        outputs = self.backbone(batch)
        if needs_ransac(cfg):
            return ransac.perspective_field_to_delta(
                outputs[cfg.learning_keys[1]], idx=idx,
                generator=generator)[0]
        if cfg.name in ('NoOpHead', 'PhotometricHead'):
            return outputs[cfg.learning_keys[3]]
        if cfg.name == 'TripletHead':
            return outputs[cfg.target_keys[0]]
        if cfg.delta_hat_keys:
            return outputs[cfg.delta_hat_keys[0]]
        u12, u21 = ((list(uniforms) + [None])[:2]
                    if isinstance(uniforms, (tuple, list))
                    else (uniforms, None))
        delta_hat = self.fit_delta(outputs[cfg.pf_keys[0]], u12, generator)
        if not (cfg.dsac_predict_bidirectional and len(cfg.pf_keys) > 1):
            return delta_hat
        pf21 = outputs[cfg.pf_keys[1]]
        delta21 = self.fit_delta(pf21, u21, generator)
        fp = geometry.image_corners(pf21.shape[1], pf21.shape[2],
                                    batch_size=pf21.shape[0],
                                    dtype=delta21.dtype, device=pf21.device)
        h21 = geometry.four_point_to_homography(fp, delta21)
        delta12p = geometry.transform_points(geometry.inv3x3(h21), fp) - fp
        return 0.5 * (delta_hat + delta12p.to(delta_hat.dtype))

    def fit_delta(self, pf: Tensor, uniforms: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tensor:
        """The predicted delta of one perspective field: the DSAC
        hypothesis (:meth:`dsac_deltas`), refitted to every point with
        DSAC_PREDICT_REFINE (:func:`dsac.refine_delta_on_pf`, at
        DSAC_PREDICT_REFINE_THRESHOLD if it is > 0, else
        SCORING_DISTANCE_THRESHOLD; ``assembled.py:790-800``)."""
        cfg = self.head
        delta = self.dsac_deltas(pf, uniforms, generator)
        if cfg.dsac_predict_refine:
            threshold = (cfg.dsac_predict_refine_threshold
                         if cfg.dsac_predict_refine_threshold > 0
                         else cfg.scoring_distance_threshold)
            delta = dsac.refine_delta_on_pf(pf, delta, threshold,
                                            cfg.dsac_predict_refine_iters)
        return delta

    def aux_features(self, x: Tensor) -> Tensor:
        """Frozen-extractor features of NHWC patches, returned NHWC (a view
        of the NCHW maps)."""
        nchw = x.permute(0, 3, 1, 2).contiguous()
        return self.auxiliary_resnet(nchw).permute(0, 2, 3, 1)

    def forward(self, batch: Dict[str, Tensor],
                uniforms: Optional[Sequence[Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        """The training forward: the backbone, then the head. For the
        PerceptualHead with DSAC, ``uniforms`` = (12 draws, 21 draws), each
        [B, points_per_hypothesis], injects the draws of the two
        directions; otherwise both come from ``generator``, 12 first. The
        other heads draw nothing."""
        cfg = self.head
        check_trainable(cfg)
        outputs = self.backbone(batch)
        data = {**batch, **outputs}
        if cfg.name == 'NoOpHead':
            return self.noop_head(data)
        if cfg.name == 'PhotometricHead':
            return self.photometric_head(data)
        if cfg.name == 'TripletHead':
            return self.triplet_head(data)
        if cfg.delta_hat_keys:
            delta_12, delta_21 = (data[k] for k in cfg.delta_hat_keys)
        else:
            delta_12, delta_21 = self.dsac_both(outputs, uniforms, generator)
        return self.bihome_loss(batch, delta_12, delta_21)

    def noop_head(self, data: Dict[str, Tensor]) -> Dict[str, object]:
        """NoOpHead (``assembled.py:166-184``): with 'all_points' delta_hat
        is the field's value at the four corner pixels."""
        gt, out, delta_gt, delta_hat = (data[k] for k in
                                        self.head.learning_keys)
        if self.head.target_gen == 'all_points':
            pf = delta_hat                                # [B,h,w,2] NHWC
            h, w = pf.shape[1], pf.shape[2]
            delta_hat = torch.stack([pf[:, 0, 0], pf[:, 0, w - 1],
                                     pf[:, h - 1, w - 1], pf[:, h - 1, 0]],
                                    dim=1)                # [B,4,2]
        return {'ground_truth': gt, 'network_output': out,
                'delta_gt': delta_gt, 'delta_hat': delta_hat, 'metrics': {}}

    def photometric_head(self, data: Dict[str, Tensor]) -> Dict[str, object]:
        """PhotometricHead (``assembled.py:188-208``): patch(i, j) =
        image(H · (x0 + j, y0 + i)) sampled straight from the full image,
        where H maps the corners to the corners plus the predicted deltas
        (the reference warps the whole image, then crops)."""
        keys = self.head.learning_keys
        corners = data['corners']
        delta_hat = data[keys[3]]
        image = data[keys[1]]
        patch_gt = data[keys[0]]
        b, ps = patch_gt.shape[0], patch_gt.shape[1]
        homography = geometry.four_point_to_homography(corners, delta_hat)
        u, v = geometry.homography_grid(homography, (ps, ps),
                                        offset=corners[:, 0])
        patch_hat = geometry.batched_sample(image, u, v).reshape(
            b, ps, ps, image.shape[-1])
        return {'ground_truth': patch_gt, 'network_output': patch_hat,
                'delta_gt': data[keys[2]], 'delta_hat': delta_hat,
                'metrics': {}}

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
        # At bf16 the patches are rounded before the warp and the warped
        # mask after it (ref: assembled.py:503-530); the warp of a bf16
        # patch is float32 (``ops/warp.sample``).
        both = cast(both, self.compute_dtype)
        warped = geometry.batched_sample(both, u, v).reshape(both.shape)
        wmask = cast(geometry.ones_warp_mask(u, v, (ps, ps)),
                     self.compute_dtype).reshape(2 * b, 1, ps, ps)
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

    def triplet_head(self, data: Dict[str, Tensor]) -> Dict[str, object]:
        """The TripletHead's loss (``_triplet_head_forward``,
        ``assembled.py:212-326``) on the ContentAware backbone's outputs.
        In training mode each ``extract_features`` call updates the
        extractor's BN running statistics (patch_1' first, then patch_2'),
        after the backbone's own pass, as flax does."""
        cfg = self.head
        if not hasattr(self.backbone, 'extract_features'):
            raise ValueError('the TripletHead needs the ContentAware backbone')
        patch_1, patch_2 = (data[k] for k in cfg.patch_keys)
        mask_1, mask_2 = (data[k] for k in cfg.mask_keys)
        f1, f2 = (data[k] for k in cfg.feature_keys)
        # Patches need not be square: CLEVR-Change trains on whole 320x240
        # renders (ref: assembled.py:108-135 takes h and w apart).
        b, h, w = patch_1.shape[:3]
        corners = geometry.image_corners(h, w, batch_size=b,
                                         dtype=patch_1.dtype,
                                         device=patch_1.device)

        def warp_pair(patch, mask, delta):
            # FIX_MASK masks are all ones: warp(mask) is the bilinear
            # support mask in closed form (ref: assembled.py:224-240).
            hom = geometry.four_point_to_homography(corners, delta)
            u, v = geometry.homography_grid(hom, (h, w))
            warped = geometry.batched_sample(patch, u, v).reshape(patch.shape)
            if self.backbone.fix_mask:
                wmask = geometry.ones_warp_mask(u, v, (h, w))
            else:
                wmask = geometry.batched_sample(mask, u, v)
            return warped, wmask.reshape(b, h, w), hom

        eye = torch.eye(3, dtype=patch_1.dtype, device=patch_1.device)
        p1p, m1p, h1 = warp_pair(patch_1, mask_1, data[cfg.target_keys[0]])
        f1p = self.backbone.extract_features(p1p)
        m1, m2 = mask_1[..., 0], mask_2[..., 0]
        if cfg.variant == 'doubleline':
            p2p, m2p, h2 = warp_pair(patch_2, mask_2,
                                     data[cfg.target_keys[1]])
            f2p = self.backbone.extract_features(p2p)
            # Learned features on both sides, the plain margin twice (ref:
            # TripletHead.py:86-100).
            ln1, ln2, fm = fused_loss.triplet_double_line(
                torch.cat([f1p, f2p], dim=0), torch.cat([f1, f2], dim=0),
                m1p * m2, m2p * m1, cfg.triplet_margin,
                cfg.triplet_aggregation, False, True)
            ln3 = ((h1 @ h2 - eye) ** 2).sum()
            loss = ln1 + ln2 + cfg.mu * ln3
            mean_l1, mean_l2, mean_l3, mean_f1, mean_f2, mean_f1p = fm[:6]
            with torch.no_grad():
                metrics = {'loss_comp/l1': mean_l1, 'loss_comp/l2': mean_l2,
                           'loss_comp/l3': mean_l3,
                           'loss_comp/ln1': ln1.detach(),
                           'loss_comp/ln2': ln2.detach(),
                           'loss_comp/ln3': cfg.mu * ln3,
                           'h/h1': ((h1 - eye) ** 2).sum(),
                           'h/h2': ((h2 - eye) ** 2).sum(),
                           'feature_space/patch_2_f': mean_f2,
                           'feature_space/patch_1_f_prime': mean_f1p,
                           'feature_space/patch_1_f': mean_f1}
        else:
            # The open-coded one-line loss (ref: assembled.py:286-304).
            l1 = (f1p - f2).abs()
            l3 = (f1 - f2).abs()
            _, loss_mat = fused_loss.hinge_aggregate(
                l1, l3, cfg.triplet_margin, cfg.triplet_aggregation, False)
            w = m1p * m2
            loss = ((w * loss_mat).sum(dim=(-2, -1))
                    / w.sum(dim=(-2, -1)).clamp_min(1.0)).sum()
            with torch.no_grad():
                metrics = {'loss_comp/l1': l1.mean(), 'loss_comp/l3': l3.mean(),
                           'h/h1': ((h1 - eye) ** 2).sum(),
                           'feature_space/patch_2_f': f2.mean(),
                           'feature_space/patch_1_f_prime': f1p.mean(),
                           'feature_space/patch_1_f': f1.mean()}
        return {'loss': loss, 'delta_gt': data.get('delta'),
                'delta_hat': data[cfg.target_keys[0]], 'metrics': metrics}
