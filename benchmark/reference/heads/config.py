"""Static head configuration parsed from the reference MODEL.HEAD yaml.

The port's own copy of ``bihome_tpu/heads/config.py`` (the JAX package
cannot be imported without JAX). One frozen config covers all four
reference heads; the fields mirror the ctor kwargs consumed by NoOpHead /
PhotometricHead / TripletHead / PerceptualHead (ref: SURVEY §2.4,
config/*/*.yaml HEAD sections). The port's predict path reads the
PerceptualHead fields; the others are parsed so that every shipped YAML
loads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    name: str = 'NoOpHead'
    # NoOpHead / PhotometricHead
    target_gen: str = '4_points'
    learning_keys: Tuple[str, ...] = ()
    # Shared
    patch_keys: Tuple[str, ...] = ('patch_1', 'patch_2')
    patch_size: int = 128
    target_keys: Tuple[str, ...] = ()
    mask_keys: Tuple[str, ...] = ()
    feature_keys: Tuple[str, ...] = ()
    variant: str = 'oneline'
    # PerceptualHead
    delta_hat_keys: Tuple[str, ...] = ()
    pf_keys: Tuple[str, ...] = ()
    hypothesis_no: int = 1
    points_per_hypothesis: int = 128
    auxiliary_resnet: str = 'resnet34'
    auxiliary_resnet_output_layer: int = 1
    auxiliary_resnet_freeze: bool = True
    # Divergence knob (documented): the reference leaves the frozen
    # extractor's BatchNorm in train mode (torch .train() touches buffers of
    # frozen modules too); we default to eval-mode BN so the loss surface is
    # deterministic and the four extractor passes fuse into one stacked pass.
    auxiliary_resnet_bn_train: bool = False
    with_projection_head: Tuple[Tuple[int, int], ...] = ()
    triplet_loss: str = ''          # '', 'one-line', 'double-line' (+'dual')
    triplet_margin: Union[float, str] = 'inf'
    triplet_aggregation: str = 'channel-agnostic'
    triplet_distance: str = 'l1'
    triplet_mu: float = 0.01
    sampling_strategy: str = 'downsample-mask'
    mask_crd: bool = False
    # TripletHead
    ld: int = 2
    mu: float = 0.01
    # DSAC scoring
    scoring_method: str = 'repr_error'
    scoring_distance_threshold: float = 3.0
    scoring_distance_beta: float = 1.0
    score_cnn_pretrained: bool = False
    # 'reference-weighted' replicates the reference's
    # torch.multinomial(arange(N), ...) point sampling, whose probability is
    # proportional to the flattened point INDEX (ref:
    # src/heads/ransac_utils.py:55-56 — arange is used as weights, so point 0
    # is never drawn); 'uniform' is the evident intent.
    dsac_point_sampling: str = 'reference-weighted'
    # Extension knob (documented, default off — shipped configs unchanged):
    # at PREDICT time, robustly re-fit the best DSAC hypothesis to ALL H*W
    # perspective-field correspondences with weights relu(1 - err/thr)
    # (the weighted-DLT refinement the reference ships but never calls,
    # ref: src/heads/ransac_utils.py:130-145). The sampled hypothesis uses
    # only POINTS_PER_HYPOTHESIS of the 16k PF points, so its delta carries
    # avoidable sampling noise; training is untouched.
    dsac_predict_refine: bool = False
    # IRLS rounds for the refit (each round re-weights by the previous
    # fit's residuals); 1 == the single weighted-DLT step.
    dsac_predict_refine_iters: int = 1
    # Inlier threshold (px) for the refit weights; <= 0 reuses
    # SCORING_DISTANCE_THRESHOLD (the training-time DSAC scoring value).
    # Predict-only: lets noisier distributions (PDS) pick a different
    # robustness radius without touching scoring.
    dsac_predict_refine_threshold: float = -1.0
    # Predict-only extension knob: fuse the DoubleLine 2->1 field's fit
    # (inverted through the corner parametrization, H12 = H21^-1) with the
    # 1->2 fit by averaging deltas — two estimates of the same homography
    # with partially independent fit noise. No-op for one-line models.
    dsac_predict_bidirectional: bool = False

    @staticmethod
    def from_yaml(head: Dict[str, Any],
                  backbone: Dict[str, Any] | None = None) -> 'HeadConfig':
        """Build from reference MODEL.HEAD (+BACKBONE for VARIANT) sections."""
        backbone = backbone or {}

        def tup(x):
            return tuple(x) if x else ()

        kw: Dict[str, Any] = {'name': head['NAME']}
        if 'TARGET_GEN' in head:
            kw['target_gen'] = head['TARGET_GEN']
        if 'LEARNING_KEYS' in head:
            kw['learning_keys'] = tup(head['LEARNING_KEYS'])
        if 'PATCH_KEYS' in head:
            kw['patch_keys'] = tup(head['PATCH_KEYS'])
        if 'PATCH_SIZE' in head:
            kw['patch_size'] = int(head['PATCH_SIZE'])
        if 'TARGET_KEYS' in head:
            kw['target_keys'] = tup(head['TARGET_KEYS'])
        if 'MASK_KEYS' in head:
            kw['mask_keys'] = tup(head['MASK_KEYS'])
        if 'FEATURE_KEYS' in head:
            kw['feature_keys'] = tup(head['FEATURE_KEYS'])
        variant = head.get('VARIANT', backbone.get('VARIANT', 'OneLine'))
        kw['variant'] = str(variant).lower()
        if 'DELTA_HAT_KEYS' in head:
            kw['delta_hat_keys'] = tup(head['DELTA_HAT_KEYS'])
        if 'PF_KEYS' in head:
            kw['pf_keys'] = tup(head['PF_KEYS'])
        if 'RANSAC_HYPOTHESIS_NO' in head:
            kw['hypothesis_no'] = max(1, int(head['RANSAC_HYPOTHESIS_NO']))
        if 'POINTS_PER_HYPOTHESIS' in head:
            kw['points_per_hypothesis'] = max(
                4, int(head['POINTS_PER_HYPOTHESIS']))
        if 'AUXILIARY_RESNET' in head:
            kw['auxiliary_resnet'] = head['AUXILIARY_RESNET']
        if 'AUXILIARY_RESNET_OUTPUT_LAYER' in head:
            kw['auxiliary_resnet_output_layer'] = int(
                head['AUXILIARY_RESNET_OUTPUT_LAYER'])
        if 'AUXILIARY_RESNET_FREEZE' in head:
            kw['auxiliary_resnet_freeze'] = bool(
                head['AUXILIARY_RESNET_FREEZE'])
        if 'AUXILIARY_RESNET_BN_TRAIN' in head:
            kw['auxiliary_resnet_bn_train'] = bool(
                head['AUXILIARY_RESNET_BN_TRAIN'])
        if head.get('WITH_PROJECTION_HEAD'):
            kw['with_projection_head'] = tuple(
                tuple(layer) for layer in head['WITH_PROJECTION_HEAD'])
        if 'TRIPLET_LOSS' in head:
            kw['triplet_loss'] = head['TRIPLET_LOSS']
        if 'TRIPLET_MARGIN' in head:
            m = head['TRIPLET_MARGIN']
            kw['triplet_margin'] = m if isinstance(m, str) else float(m)
        if 'TRIPLET_AGGREGATION' in head:
            kw['triplet_aggregation'] = head['TRIPLET_AGGREGATION']
        if 'TRIPLET_DISTANCE' in head:
            kw['triplet_distance'] = head['TRIPLET_DISTANCE']
        if 'TRIPLET_MU' in head:
            kw['triplet_mu'] = float(head['TRIPLET_MU'])
        if 'SAMPLING_STRATEGY' in head:
            kw['sampling_strategy'] = head['SAMPLING_STRATEGY']
        if 'MASK_CRD' in head:
            kw['mask_crd'] = bool(head['MASK_CRD'])
        if 'LD' in head:
            kw['ld'] = int(head['LD'])
        if 'MU' in head:
            kw['mu'] = float(head['MU'])
        if 'SCORING_METHOD' in head:
            kw['scoring_method'] = head['SCORING_METHOD']
        if 'SCORING_DISTANCE_THRESHOLD' in head:
            kw['scoring_distance_threshold'] = float(
                head['SCORING_DISTANCE_THRESHOLD'])
        if 'SCORING_DISTANCE_BETA' in head:
            kw['scoring_distance_beta'] = float(head['SCORING_DISTANCE_BETA'])
        if 'SCORE_CNN_PRETRAINED' in head:
            kw['score_cnn_pretrained'] = bool(head['SCORE_CNN_PRETRAINED'])
        if 'DSAC_POINT_SAMPLING' in head:
            kw['dsac_point_sampling'] = head['DSAC_POINT_SAMPLING']
        if 'DSAC_PREDICT_REFINE' in head:
            kw['dsac_predict_refine'] = bool(head['DSAC_PREDICT_REFINE'])
        if 'DSAC_PREDICT_REFINE_ITERS' in head:
            kw['dsac_predict_refine_iters'] = int(
                head['DSAC_PREDICT_REFINE_ITERS'])
        if 'DSAC_PREDICT_REFINE_THRESHOLD' in head:
            kw['dsac_predict_refine_threshold'] = float(
                head['DSAC_PREDICT_REFINE_THRESHOLD'])
        if 'DSAC_PREDICT_BIDIRECTIONAL' in head:
            kw['dsac_predict_bidirectional'] = bool(
                head['DSAC_PREDICT_BIDIRECTIONAL'])
        return HeadConfig(**kw)
