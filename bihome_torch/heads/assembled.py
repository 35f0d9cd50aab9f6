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
* ``PerceptualHead`` with DSAC (zeng-biHomE: backbone perspective fields
  -> sampled points -> DLT -> corner deltas, ``:354-396``; with
  RANSAC_HYPOTHESIS_NO n > 1 or SCORING_METHOD score_cnn each hypothesis
  scored by one of the four methods of :func:`dsac.score_hypotheses`, the
  score CNN a 2-channel resnet18 on the error image; at predict the
  best-scored hypothesis, the all-points refit DSAC_PREDICT_REFINE and
  the average with the inverted 2->1 fit DSAC_PREDICT_BIDIRECTIONAL,
  ``:790-826``), or with ``DELTA_HAT_KEYS`` (the regression backbone's
  deltas, n = 1, ``:336-340``). With n hypotheses the loss runs on each
  patch n times (``jnp.repeat``, ``:491-496``): the scores weight the
  one-line loss and the multihead features, and delta_hat is the
  score-weighted sum of the hypotheses' deltas (``:426-432``); the
  double-line loss does not weigh by them, as in JAX (``:726``). Its
  training forward is the biHomE loss
  (``_triplet_resnet_loss``, ``:482-728``) with every variant of that
  function: one warp of the patches (double-line: both directions
  stacked), the warped all-ones mask in closed form, or with MASK_KEYS
  the backbone's masks as a second channel of the same warp; the
  SAMPLING_STRATEGY upsample-patch-{2,4}x bilinear upsampling before the
  extractor (``:42-53, 137-142``); the extractor run twice (plain patches
  without gradient, warped patches with input gradients), through the
  WITH_PROJECTION_HEAD Dense layers, in training-mode BN under
  AUXILIARY_RESNET_BN_TRAIN; the masks pooled to the features'
  resolution; then the one-line loss (l1 or cosine, the float margin,
  MASK_CRD, the scores), the fused double-line l1 tail, or the
  open-coded double-line tail (l1, l2 or cosine distances, both
  aggregations, 'inf' or a float margin), plus ``TRIPLET_MU`` times the
  homography consistency term, the 'dual' term on the ContentAware
  backbone's feature extractor, and the metrics of ``:652-725`` under
  the same keys. TRIPLET_LOSS '' is ``_multihead_loss`` (``:398-424``):
  the feature pair for the trainer's tensor loss.
* ``TripletHead`` (Zhang et al.'s CA-UDHN loss, ``:212-326``): both
  patches warped by the predicted deltas, the support mask in closed form
  under FIX_MASK (else the predicted masks warped too), the backbone's
  feature extractor re-run in the model's mode on each warped patch, the
  fused triplet tail with learned features on both sides (DoubleLine) or
  the open-coded one-line loss, and the ``MU`` consistency term.
* ``predict`` for all four (``:762-826``).

``forward`` returns the JAX keys: ``{'ground_truth', 'network_output',
'delta_gt', 'delta_hat', 'metrics'}`` for the tensor-loss heads (and the
multihead loss), ``{'loss', 'delta_gt', 'delta_hat', 'metrics'}`` for
the biHomE loss. Other heads raise ``not ported yet``. The
PerceptualHead's auxiliary
extractor takes no parameter gradient, whatever AUXILIARY_RESNET_FREEZE
says (the JAX train step cuts it out of autodiff in every step); its BN
stays in eval mode unless AUXILIARY_RESNET_BN_TRAIN (``heads/config.py``).
The projection head's parameters train, and so do the score CNN's, whose
BN always normalises with its running statistics (flax calls it with
``train=False``, ``:385-386``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bihome_torch import geometry, tracing
from bihome_torch.heads import dsac, ransac
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models.layers import Linear, cast
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


def needs_score_cnn(cfg: HeadConfig) -> bool:
    """Whether the head holds the DSAC score CNN (``assembled.py:80-82``)."""
    return needs_dsac(cfg) and cfg.scoring_method == 'score_cnn'


def check_ported(cfg: HeadConfig) -> None:
    """Raise for the head features this port does not have yet."""
    missing = []
    if cfg.name not in ('NoOpHead', 'PhotometricHead', 'PerceptualHead',
                        'TripletHead'):
        missing.append(f'head {cfg.name!r}')
    if cfg.name == 'NoOpHead' and cfg.target_gen not in ('4_points',
                                                         'all_points'):
        missing.append(f'NoOpHead TARGET_GEN {cfg.target_gen!r}')
    if missing:
        raise ValueError('not ported yet: ' + ', '.join(missing))


def _linspace(stop: float, num: int, device) -> Tensor:
    """``jnp.linspace(0, stop, num)`` in float32, bit for bit as XLA
    compiles it: point i is i * fl(fl(1 / (num - 1)) * stop), the last
    exactly ``stop``. ``torch.linspace`` rounds most points otherwise (by
    up to 7.6e-6 over 128 pixels)."""
    div = num - 1
    step = tracing.to_device(torch.tensor(1.0) / div * stop, device)
    head = torch.arange(div, dtype=torch.float32, device=device) * step
    return torch.cat([head, torch.full((1,), float(stop), device=device)])


def upsample_grid(b: int, h: int, w: int, scale: int, device
                  ) -> Tuple[Tensor, Tensor]:
    """(u, v) [b, h*scale * w*scale]: the align_corners output grid of a
    ``scale``-times upsample in input pixels, one row broadcast over the
    batch (``assembled.py:46-51``)."""
    oh, ow = h * scale, w * scale
    xs = _linspace(w - 1.0, ow, device)
    ys = _linspace(h - 1.0, oh, device)
    return (xs.repeat(oh).expand(b, -1),
            ys.repeat_interleave(ow).expand(b, -1))


def upsample_align_corners(x: Tensor, scale: int) -> Tensor:
    """Bilinear 2x/4x upsample of NHWC ``x`` with torch's align_corners
    semantics (``assembled.py:42-53``, ref: PerceptualHead.py:317-318):
    :func:`upsample_grid` sampled by :func:`geometry.batched_sample` (K3;
    K5 backward where ``x`` requires grad; the grid is constant, so no
    K4). K3 and K5 read its one row (batch stride 0,
    ``ops/warp.BilinearSample``): the grid is materialised nowhere, as
    JAX's ``broadcast_to`` grid (``assembled.py:41-51``)."""
    b, h, w, c = x.shape
    u, v = upsample_grid(b, h, w, scale, x.device)
    return geometry.batched_sample(x, u, v).reshape(b, h * scale,
                                                    w * scale, c)


def per_hypothesis(x: Tensor, n: int) -> Tensor:
    """Each sample of ``x`` n times in a row (``jnp.repeat(x, n, axis=0)``,
    ``assembled.py:491-496``), the layout of the hypotheses' deltas."""
    return x if n == 1 else x.repeat_interleave(n, dim=0)


def pool_mask(mask: Tensor, factor: int) -> Tensor:
    """AvgPool2d(kernel = stride = ``factor``) of a [B,h,w,1] mask ->
    [B,h/factor,w/factor] (``assembled.py:56-60``, ref:
    PerceptualHead.py:447-459)."""
    m = mask[..., 0]
    return m if factor <= 1 else F.avg_pool2d(m[:, None], factor)[:, 0]


def triplet_distances(fa: Tensor, fb: Tensor, distance: str) -> Tensor:
    """Per-pixel distance of NHWC feature maps: channel-resolved for 'l1',
    channel-reduced for 'l2' and 'cosine' (``assembled.py:436-450``, ref:
    PerceptualHead.py:543-606)."""
    if distance == 'l1':
        return (fa - fb).abs()                                # [.,h,w,C]
    if distance == 'l2':
        return ((fa - fb) ** 2).mean(-1)                      # [.,h,w]
    if distance == 'cosine':
        num = (fa * fb).sum(-1)
        den = (torch.linalg.vector_norm(fa, dim=-1)
               * torch.linalg.vector_norm(fb, dim=-1)).clamp_min(1e-8)
        return 1.0 - num / den
    raise ValueError(distance)


def hinge(l_pos: Tensor, l_anchor: Tensor, margin) -> Tensor:
    """``_triplet_margin_aggregate`` (``assembled.py:452-481``) for the
    channel-reduced distances ('l2', 'cosine': [.,h,w]), where the
    aggregation has nothing to sum: l_pos - l_anchor under the margin
    'inf', else the hinge max(l_pos - l_anchor + margin, 0). (The
    channel-resolved 'l1' goes through the fused tail.)"""
    diff = l_pos - l_anchor
    return diff if isinstance(margin, str) else (diff + margin).clamp_min(0.0)


def masked_mean(loss_mat: Tensor, weights: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """(sum over the batch of sum(w * loss) / max(sum w, 1), the per-sample
    sums of w [B])."""
    den = weights.sum(dim=(-2, -1))
    return ((weights * loss_mat).sum(dim=(-2, -1))
            / den.clamp_min(1.0)).sum(), den


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
        self.auxiliary_resnet = self.projection_head = None
        self.score_cnn = None
        if head.name == 'PerceptualHead':
            # The extractor never takes a parameter gradient, whatever
            # AUXILIARY_RESNET_FREEZE says: the JAX train step cuts it out
            # of autodiff in every step (trainer.py:62-73).
            self.auxiliary_resnet = ResNet(
                arch=head.auxiliary_resnet,
                output_layer=head.auxiliary_resnet_output_layer)
            self.auxiliary_resnet.requires_grad_(False)
            if head.with_projection_head:
                # Linear layers at even indices, a ReLU between two (the
                # reference's layout, PerceptualHead.py:43-48; flax's
                # projection_{i}, assembled.py:75-79).
                layers = []
                for i, (cin, cout) in enumerate(head.with_projection_head):
                    layers += [nn.ReLU()] if i else []
                    layers.append(Linear(cin, cout))
                self.projection_head = nn.Sequential(*layers)
            if needs_score_cnn(head):
                self.score_cnn = ResNet('resnet18', output_layer=None,
                                        in_channels=2, num_classes=1)
        self.train()

    def train(self, mode: bool = True) -> 'AssembledModel':
        """The extractor's BN runs on batch statistics, and updates its
        running ones, only in a training forward with
        AUXILIARY_RESNET_BN_TRAIN, and never in the multihead loss
        (``assembled.py:100, 406``); the score CNN's never
        (``:385-386``)."""
        super().train(mode)
        if self.auxiliary_resnet is not None:
            cfg = self.head
            self.auxiliary_resnet.train(
                mode and cfg.auxiliary_resnet_bn_train
                and cfg.triplet_loss != '')
        if self.score_cnn is not None:
            self.score_cnn.train(False)
        return self

    @property
    def draws_on_device(self) -> bool:
        """Whether predict's draws are made on the field's device (RANSAC's
        point indices) rather than on the CPU (DSAC's uniforms)."""
        return needs_ransac(self.head)

    def score_image(self, img: Tensor) -> Tensor:
        """The score CNN on the NHWC error image [B*n,h,w,2] -> [B*n,1]."""
        return self.score_cnn(img.permute(0, 3, 1, 2).contiguous())

    def dsac_deltas(self, pf: Tensor, uniforms: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[Tensor, Tensor]:
        """PF [B,h,w,2] -> (corner deltas [B*n,4,2] of the n DSAC
        hypotheses, sample-major as ``jnp.repeat`` lays out the patches;
        their scores [B,n]) (``assembled.py:354-396``). With one hypothesis
        and no score CNN, softmax(-score) is identically 1, so scoring is
        skipped and only the sampled points are read, as in the JAX
        package. Otherwise the coordinates and the mapping coords + pf
        are float32 (float64 for a float64 field; a bfloat16 field
        widens, as JAX's float32 meshgrid widens it), the hypotheses are
        drawn from the two clouds and scored. The deltas are float32 for
        a bfloat16 field, as ``:391-395`` gives them. ``uniforms``
        [B, n * points_per_hypothesis] injects the draws; ``rows`` places
        the batch in a global one (:func:`dsac.sample_point_indices`)."""
        cfg = self.head
        b, h, w, _ = pf.shape
        n = cfg.hypothesis_no
        if n == 1 and cfg.scoring_method != 'score_cnn':
            hyps = dsac.sample_hypotheses_from_pf(
                pf, n, cfg.points_per_hypothesis, cfg.dsac_point_sampling,
                uniforms, generator, rows)                        # [B,1,3,3]
            scores = torch.ones((b, 1), dtype=pf.dtype, device=pf.device)
        else:
            dtype = torch.promote_types(pf.dtype, torch.float32)
            ys, xs = torch.meshgrid(
                torch.arange(h, dtype=dtype, device=pf.device),
                torch.arange(w, dtype=dtype, device=pf.device), indexing='ij')
            coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
            coords = coords[None].expand(b, h * w, 2)
            mapping = coords + pf.reshape(b, -1, 2).to(dtype)
            hyps = dsac.sample_hypotheses(
                coords, mapping, n, cfg.points_per_hypothesis,
                cfg.dsac_point_sampling, uniforms, generator, rows)
            with tracing.span('dsac.score'):
                scores, _ = dsac.score_hypotheses(
                    coords, mapping, hyps, cfg.scoring_method,
                    cfg.scoring_distance_threshold, cfg.scoring_distance_beta,
                    self.score_image if self.score_cnn is not None else None)
        four_points = geometry.image_corners(h, w, batch_size=b * n,
                                             dtype=hyps.dtype,
                                             device=pf.device)
        transformed = geometry.transform_points(hyps.reshape(-1, 3, 3),
                                                four_points)
        return transformed - four_points, scores

    @staticmethod
    def score_weighted_delta(deltas: Tensor, scores: Optional[Tensor],
                             b: int) -> Tensor:
        """delta_hat [B,4,2] of the hypotheses' deltas [B*n,4,2]: their sum
        weighted by the scores [B,n] (``_score_weighted_delta``,
        ``assembled.py:426-432``); the deltas themselves without scores
        (n = 1)."""
        if scores is None:
            return deltas
        n = scores.shape[1]
        return (deltas.reshape(b, n, 4, 2)
                * scores.reshape(b, n, 1, 1)).sum(1)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, Tensor],
                uniforms=None,
                generator: Optional[torch.Generator] = None,
                idx: Optional[Tensor] = None) -> Tensor:
        """:meth:`predict_delta` in inference mode."""
        return self.predict_delta(batch, uniforms, generator, idx)

    def predict_delta(self, batch: Dict[str, Tensor],
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
        injects the DSAC draws, [B, n * points_per_hypothesis] for the 1->2
        field or a sequence (1->2[, 2->1]); the draws it does not give
        come from ``generator``, the 1->2 field's first (RANSAC draws on
        the field's device, so its generator lives there)."""
        with tracing.span('model.backbone'):
            outputs = self.backbone(batch)
        with tracing.span('model.head'):
            return self._predict_head(outputs, uniforms, generator, idx)

    def _predict_head(self, outputs, uniforms, generator, idx) -> Tensor:
        """delta_hat from the backbone's outputs (:meth:`predict_delta`)."""
        cfg = self.head
        if needs_ransac(cfg):
            with tracing.span('model.ransac'):
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
        with tracing.span('model.dsac'):
            delta_hat = self.fit_delta(outputs[cfg.pf_keys[0]], u12,
                                       generator)
        if not (cfg.dsac_predict_bidirectional and len(cfg.pf_keys) > 1):
            return delta_hat
        pf21 = outputs[cfg.pf_keys[1]]
        with tracing.span('model.dsac'):
            delta21 = self.fit_delta(pf21, u21, generator)
        fp = geometry.image_corners(pf21.shape[1], pf21.shape[2],
                                    batch_size=pf21.shape[0],
                                    dtype=delta21.dtype, device=pf21.device)
        h21 = geometry.four_point_to_homography(fp, delta21)
        delta12p = geometry.transform_points(geometry.inv3x3(h21), fp) - fp
        return 0.5 * (delta_hat + delta12p.to(delta_hat.dtype))

    def fit_delta(self, pf: Tensor, uniforms: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tensor:
        """The predicted delta of one perspective field: the best-scored
        DSAC hypothesis (:meth:`dsac_deltas`; ties to the first, as
        ``jnp.argmax``), refitted to every point with DSAC_PREDICT_REFINE
        (:func:`dsac.refine_delta_on_pf`, at DSAC_PREDICT_REFINE_THRESHOLD
        if it is > 0, else SCORING_DISTANCE_THRESHOLD;
        ``assembled.py:790-800``)."""
        cfg = self.head
        b = pf.shape[0]
        deltas, scores = self.dsac_deltas(pf, uniforms, generator)
        best = scores.argmax(dim=-1)                              # [B]
        delta = deltas.reshape(b, -1, 4, 2)[
            torch.arange(b, device=pf.device), best]
        if cfg.dsac_predict_refine:
            threshold = (cfg.dsac_predict_refine_threshold
                         if cfg.dsac_predict_refine_threshold > 0
                         else cfg.scoring_distance_threshold)
            delta = dsac.refine_delta_on_pf(pf, delta, threshold,
                                            cfg.dsac_predict_refine_iters)
        return delta

    def aux_features(self, x: Tensor) -> Tensor:
        """Extractor features of NHWC patches, returned NHWC (a view of the
        NCHW maps), through the projection head where the config has one
        (``_aux_features``, ``assembled.py:86-107``)."""
        with tracing.span('model.extractor'):
            nchw = x.permute(0, 3, 1, 2).contiguous()
            f = self.auxiliary_resnet(nchw).permute(0, 2, 3, 1)
            return (f if self.projection_head is None
                    else self.projection_head(f))

    def forward(self, batch: Dict[str, Tensor],
                uniforms: Optional[Sequence[Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Dict[str, object]:
        """The training forward: the backbone, then the head. For the
        PerceptualHead with DSAC, ``uniforms`` = (12 draws, 21 draws), each
        [B, n * points_per_hypothesis], injects the draws of the two
        directions (the 2->1 field is fitted only for a double-line loss);
        otherwise they come from ``generator``, 12 first, and with
        ``rows`` = (lo, total) they are those of rows [lo, lo + B) of a
        global batch of ``total`` (:func:`dsac.sample_point_indices`). The
        other heads draw nothing."""
        with tracing.span('model.backbone'):
            outputs = self.backbone(batch)
        tracing.mark_gradients('bwd.backbone', outputs.values())
        with tracing.span('model.head'):
            return self._head_forward({**batch, **outputs}, outputs,
                                      uniforms, generator, rows)

    def _head_forward(self, data, outputs, uniforms, generator, rows):
        """The training forward after the backbone (:meth:`forward`)."""
        cfg = self.head
        if cfg.name == 'NoOpHead':
            return self.noop_head(data)
        if cfg.name == 'PhotometricHead':
            return self.photometric_head(data)
        if cfg.name == 'TripletHead':
            return self.triplet_head(data)
        doubleline = 'double-line' in cfg.triplet_loss
        scores = None
        if cfg.delta_hat_keys:
            delta_12 = data[cfg.delta_hat_keys[0]]
            delta_21 = data[cfg.delta_hat_keys[1]] if doubleline else None
        else:
            with tracing.span('model.dsac'):
                delta_12, delta_21, scores = self.dsac_both(
                    outputs, uniforms, generator, rows)
            tracing.mark_gradients('bwd.deltas', (delta_12, delta_21))
        with tracing.span('model.loss'):
            if cfg.triplet_loss == '':
                return self.multihead_loss(data, delta_12, scores)
            return self.bihome_loss(data, delta_12, delta_21, scores)

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
                  generator: Optional[torch.Generator] = None,
                  rows: Optional[Tuple[int, int]] = None):
        """(delta_12, delta_21 [B*n,4,2], the 1->2 hypotheses' scores
        [B,n]) from the perspective fields, the 1->2 direction's draws
        first; delta_21 is None unless the loss is double-line (whose
        scores weigh nothing, ``assembled.py:344-345``)."""
        cfg = self.head
        u12, u21 = uniforms if uniforms is not None else (None, None)
        delta_12, scores = self.dsac_deltas(outputs[cfg.pf_keys[0]], u12,
                                            generator, rows)
        if 'double-line' not in cfg.triplet_loss:
            return delta_12, None, scores
        delta_21, _ = self.dsac_deltas(outputs[cfg.pf_keys[1]], u21,
                                       generator, rows)
        return delta_12, delta_21, scores

    @staticmethod
    def _homographies(delta: Tensor, ps: int) -> Tensor:
        """H [N,3,3] mapping the patch corners to the corners plus the
        deltas [N,4,2], in float32 (float64 for float64 deltas: the CPU
        references), as ``_warp`` builds it at any compute dtype."""
        corners = geometry.image_corners(
            ps, ps, batch_size=delta.shape[0],
            dtype=torch.promote_types(delta.dtype, torch.float32),
            device=delta.device)
        return geometry.four_point_to_homography(corners, delta)

    def _warp_pair(self, image: Tensor, delta: Tensor, masked: bool):
        """The loss warp (``_warp`` / ``_warp_with_support``,
        ``assembled.py:110-135``) of [N,ps,ps,C] by the homographies of
        the corner deltas [N,4,2] -> (warped patch [N,ps,ps,1] float32,
        warped mask [N,ps,ps,1], H [N,3,3]). ``masked``: the mask is the
        image's second channel, warped with it (K3, K4 and K5 at C = 2
        where the mask takes a gradient); else the mask is all ones and
        its warp the bilinear support mask in closed form, in the compute
        dtype."""
        n, ps = image.shape[0], image.shape[1]
        hom = self._homographies(delta, ps)
        if masked:
            warped = geometry.warp_image(image, hom)
            return warped[..., :1], warped[..., 1:], hom
        u, v = geometry.homography_grid(hom, (ps, ps))
        warped = geometry.batched_sample(image, u, v).reshape(image.shape)
        wmask = cast(geometry.ones_warp_mask(u, v, (ps, ps)),
                     self.compute_dtype).reshape(n, ps, ps, 1)
        return warped, wmask, hom

    def _upsample(self, x: Tensor) -> Tensor:
        """SAMPLING_STRATEGY upsample-patch-{2,4}x (``_maybe_upsample``,
        ``assembled.py:137-142``); 'downsample-mask' leaves the patch."""
        scale = {'upsample-patch-4x': 4, 'upsample-patch-2x': 2}.get(
            self.head.sampling_strategy)
        return x if scale is None else upsample_align_corners(x, scale)

    def bihome_loss(self, data: Dict[str, Tensor], delta_12: Tensor,
                    delta_21: Optional[Tensor] = None,
                    scores: Optional[Tensor] = None) -> Dict[str, object]:
        """The biHomE loss (``_triplet_resnet_loss``,
        ``assembled.py:482-728``) for the corner deltas [B*n,4,2] of one
        direction (one-line) or both (double-line): each patch (and mask)
        repeated once per hypothesis, as ``jnp.repeat(axis=0)``; the DSAC
        ``scores`` [B,n] weight the one-line loss and delta_hat. The patches
        (and MASK_KEYS' masks, else ones) are cast to the compute dtype;
        the warps and upsampling of bf16 inputs are float32
        (``ops/warp.sample``, whose autograd casts the image gradient back
        to the input's dtype)."""
        cfg = self.head
        dt = self.compute_dtype
        doubleline = 'double-line' in cfg.triplet_loss
        e1, e2 = cfg.patch_keys
        b_data = data[e1].shape[0]
        n = delta_12.shape[0] // b_data
        patch_1, patch_2 = (cast(per_hypothesis(data[k], n), dt)
                            for k in (e1, e2))
        b, ps = patch_1.shape[0], patch_1.shape[1]
        masked = bool(cfg.mask_keys)
        if masked:
            mask_1, mask_2 = (cast(per_hypothesis(data[k], n), dt)
                              for k in cfg.mask_keys)
        else:
            mask_1 = mask_2 = torch.ones_like(patch_1)

        # One warp: both directions stacked on the batch axis (double-
        # line), the mask riding as a second channel (MASK_KEYS).
        src, delta = patch_1, delta_12
        if masked:
            src = torch.cat([patch_1, mask_1], dim=-1)
        if doubleline:
            src = torch.cat([src, torch.cat([patch_2, mask_2], dim=-1)
                             if masked else patch_2])
            delta = torch.cat([delta_12, delta_21])
        warped, wmask, hom = self._warp_pair(src, delta, masked)
        h1 = hom[:b]

        # The plain patches are data: their features carry no gradient. The
        # warped pass carries input gradients into the warp (and the
        # upsampling) only; the extractor's parameters never require grad.
        with torch.no_grad():
            feats_plain = self.aux_features(
                self._upsample(torch.cat([patch_1, patch_2])))
        f1, f2 = feats_plain[:b], feats_plain[b:]
        feats_w = self.aux_features(self._upsample(warped))
        f1p = feats_w[:b]
        # Mask downsampling to feature resolution (always on, as the
        # reference's `or True`, PerceptualHead.py:448).
        factor = ps // feats_w.shape[1]
        wmask_d = pool_mask(wmask, factor)
        m1p_d, m2_d = wmask_d[:b], pool_mask(mask_2, factor)
        m1_d = pool_mask(mask_1, factor)

        metrics: Dict[str, Tensor] = {}
        eye = torch.eye(3, dtype=h1.dtype, device=h1.device)
        if 'one-line' in cfg.triplet_loss:
            fa, fb, fc = f1p, f2, f1
            if self.projection_head is not None:
                fa, fb, fc = (f / torch.linalg.vector_norm(
                    f, dim=-1, keepdim=True).clamp_min(1e-8)
                    for f in (fa, fb, fc))
            if cfg.triplet_distance == 'l1':
                l1 = (fa - fb).abs().sum(-1)
                l3 = (fc - fb).abs().sum(-1)
            elif cfg.triplet_distance == 'cosine':
                l1 = triplet_distances(fa, fb, 'cosine')
                l3 = triplet_distances(fc, fb, 'cosine')
            else:
                raise ValueError(cfg.triplet_distance)
            margin = (0.0 if isinstance(cfg.triplet_margin, str)
                      else cfg.triplet_margin)
            loss_mat = (l1 - l3 + margin).clamp_min(0.0)
            if scores is not None:
                loss_mat = loss_mat * scores.reshape(b, 1, 1)
            loss, _ = masked_mean(loss_mat,
                                  m1p_d if cfg.mask_crd else m1p_d * m2_d)
        elif not doubleline:
            raise ValueError(f'Unknown TRIPLET_LOSS: {cfg.triplet_loss}')
        else:
            h2 = hom[b:]
            f2p = feats_w[b:]
            m2p_d = wmask_d[b:]
            ln3 = ((h1 @ h2 - eye) ** 2).sum()
            if cfg.triplet_distance == 'l1':
                # The fused tail (ops/fused_loss.py), which also returns
                # the masks' cotangents.
                ln1, ln2, fm = fused_loss.triplet_double_line(
                    feats_w, feats_plain, m1p_d * m2_d, m2p_d * m1_d,
                    cfg.triplet_margin, cfg.triplet_aggregation, True,
                    False)
                (mean_l1, mean_l2, mean_l3, mean_f1, mean_f2, mean_f1p,
                 den1, den2) = fm
                metrics.update({'loss_comp/l2': mean_l2,
                                'feature_space/patch_1_f': mean_f1,
                                'feature_space/patch_2_f': mean_f2,
                                'feature_space/patch_1_f_prime': mean_f1p,
                                'loss_comp/l1': mean_l1,
                                'loss_comp/l3': mean_l3})
            else:
                # The open-coded tail of the channel-reduced distances
                # (assembled.py:672-706).
                dist = cfg.triplet_distance
                l3 = triplet_distances(f1, f2, dist)
                ln1, den1 = masked_mean(hinge(
                    triplet_distances(f1p, f2, dist), l3,
                    cfg.triplet_margin), m1p_d * m2_d)
                ln2, den2 = masked_mean(hinge(
                    triplet_distances(f2p, f1, dist), l3,
                    cfg.triplet_margin), m2p_d * m1_d)
                den1, den2 = den1.min(), den2.min()
                metrics['loss_comp/l2'] = (f1 - f2p).abs().mean()
            loss = ln1 + ln2 + cfg.triplet_mu * ln3
            metrics.update({'loss_comp/ln1': ln1, 'loss_comp/ln2': ln2,
                            'loss_comp/ln3': cfg.triplet_mu * ln3,
                            'loss_den/l1_den': den1,
                            'loss_den/l2_den': den2,
                            'h/h2': ((h2 - eye) ** 2).sum()})
        if 'dual' in cfg.triplet_loss:
            loss = loss + self.dual_loss(
                patch_1, patch_2, warped[:b],
                warped[b:] if doubleline else None, mask_1[..., 0],
                mask_2[..., 0], wmask[:b, ..., 0],
                wmask[b:, ..., 0] if doubleline else None)
        shared = {'feature_space/patch_1_f': lambda: f1.mean(),
                  'feature_space/patch_2_f': lambda: f2.mean(),
                  'feature_space/patch_1_f_prime': lambda: f1p.mean(),
                  'loss_comp/l1': lambda: (f2 - f1p).abs().mean(),
                  'loss_comp/l3': lambda: (f2 - f1).abs().mean(),
                  'h/h1': lambda: ((h1 - eye) ** 2).sum()}
        with torch.no_grad():
            for key, fn in shared.items():
                if key not in metrics:
                    metrics[key] = fn()
            metrics = {k: v.detach() for k, v in metrics.items()}
        return {'loss': loss, 'delta_gt': data.get('delta'),
                'delta_hat': self.score_weighted_delta(delta_12, scores,
                                                       b_data),
                'metrics': metrics}

    def dual_loss(self, p1: Tensor, p2: Tensor, p1p: Tensor,
                  p2p: Optional[Tensor], m1: Tensor, m2: Tensor, m1p: Tensor,
                  m2p: Optional[Tensor]) -> Tensor:
        """The 'dual' term (``_dual_loss``, ``assembled.py:730-756``): the
        ContentAware backbone's own feature extractor on the plain and
        warped patches (each call updating its BN running statistics in
        training mode), the unhinged masked l1 triplet at full
        resolution; masks [B,h,w]."""
        if not hasattr(self.backbone, 'extract_features'):
            raise ValueError('the dual loss needs the ContentAware backbone')
        ext = self.backbone.extract_features
        f1, f2, f1p = ext(p1), ext(p2), ext(p1p)
        l3 = (f1 - f2).abs().sum(-1)
        loss, _ = masked_mean((f1p - f2).abs().sum(-1) - l3, m1p * m2)
        if p2p is not None:
            loss2, _ = masked_mean((ext(p2p) - f1).abs().sum(-1) - l3,
                                   m2p * m1)
            loss = loss + loss2
        return loss

    def multihead_loss(self, data: Dict[str, Tensor], delta_12: Tensor,
                       scores: Optional[Tensor] = None) -> Dict[str, object]:
        """TRIPLET_LOSS '' (``_multihead_loss``, ``assembled.py:398-424``):
        the extractor's features of patch_2 and of patch_1 warped by the
        deltas [B*n,4,2] (each patch repeated once per hypothesis;
        eval-mode BN) as ground_truth and network_output for the trainer's
        tensor loss, each weighted by the ``scores`` [B,n]."""
        cfg = self.head
        b_data = data[cfg.patch_keys[0]].shape[0]
        n = delta_12.shape[0] // b_data
        patch_1, patch_2 = (per_hypothesis(data[k], n)
                            for k in cfg.patch_keys)
        b, ps = patch_1.shape[0], patch_1.shape[1]
        h1 = self._homographies(delta_12, ps)
        feats = self.aux_features(torch.cat(
            [patch_2, geometry.warp_image(patch_1, h1)]))
        f2, f1p = feats[:b], feats[b:]
        if scores is not None:
            s = scores.reshape(b, 1, 1, 1)
            f1p, f2 = f1p * s, f2 * s
        eye = torch.eye(3, dtype=h1.dtype, device=h1.device)
        with torch.no_grad():
            metrics = {'feature_space/patch_2_f': f2.mean(),
                       'feature_space/patch_1_f_prime': f1p.mean(),
                       'loss_comp/l1': (f2 - f1p).abs().mean(),
                       'h/h1': ((h1 - eye) ** 2).sum()}
        return {'ground_truth': f2, 'network_output': f1p,
                'delta_gt': data.get('delta'),
                'delta_hat': self.score_weighted_delta(delta_12, scores,
                                                       b_data),
                'metrics': metrics}

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
