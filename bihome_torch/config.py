"""Config loading and model assembly for the port (counterpart of
``bihome_tpu/config.py:22-134``).

Reads the same reference-schema YAMLs. ``build_model`` assembles the
backbone (``build_backbone``: Rethinking of either flavour, ResNet34 or
ContentAware) with its head (NoOpHead, PhotometricHead, PerceptualHead or
TripletHead) and the pair specs, which
emit the full ``image_1`` where the PhotometricHead reads it, at the
compute dtype of MODEL.DTYPE (float32 or bfloat16);
``solver_kwargs`` reads the optimizer settings. Other families raise
``ValueError('not ported yet: ...')``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import yaml

from bihome_torch.data.pipeline import PairSpec, check_ported
from bihome_torch.heads.assembled import AssembledModel, needs_dsac
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models import layers
from bihome_torch.models.backbones import build_backbone


def load_config(path: str) -> Dict[str, Any]:
    with open(path, 'r') as f:
        return yaml.full_load(f)


def apply_overrides(config: Dict[str, Any], overrides) -> Dict[str, Any]:
    """Apply dotted-key CLI overrides in place: 'A.B.C=val'.

    Values parse as YAML scalars ('1e-3' -> float, 'true' -> bool, bare
    words -> str); intermediate dicts are created as needed."""
    for item in overrides or ():
        key, sep, raw = item.partition('=')
        if not sep:
            raise ValueError(f'--set expects KEY=VALUE, got {item!r}')
        node = config
        parts = key.split('.')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f'{key}: {part} is not a mapping')
        value = yaml.safe_load(raw) if raw != '' else ''
        if isinstance(value, str):
            # YAML 1.1 only floats '1.0e-4', not '1e-4' — accept both.
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
        node[parts[-1]] = value
    return config


def _emit_images_for(head_cfg: HeadConfig) -> Tuple[str, ...]:
    """The full-size images the head reads: the PhotometricHead's
    LEARNING_KEYS[1] (``bihome_tpu/config.py:59-69``), else none."""
    if head_cfg.name == 'PhotometricHead':
        return (head_cfg.learning_keys[1],)
    return ()


@dataclasses.dataclass
class BuiltModel:
    model: AssembledModel
    head_cfg: HeadConfig
    pair_spec: PairSpec
    test_pair_spec: PairSpec
    loss_name: str
    config: Dict[str, Any]
    dtype: torch.dtype = torch.float32

    @property
    def needs_dsac_rng(self) -> bool:
        return needs_dsac(self.head_cfg)


def build_model(config: Dict[str, Any], dtype=None) -> BuiltModel:
    """Assemble the model (weights from the module init — callers seed or
    load them) and the train/test pair specs. Compute dtype: ``dtype``
    (a torch dtype or its name) if given, else MODEL.DTYPE ('float32' or
    'bfloat16'), else float32 (``bihome_tpu/config.py:87-96``); the
    parameters stay float32. At bfloat16 the train spec's warp source is
    bf16 (``:109``), the test spec's float32."""
    model_cfg = config['MODEL']
    if dtype is None:
        dtype = model_cfg.get('DTYPE', 'float32')
    if isinstance(dtype, str):
        if dtype not in layers.DTYPES:
            raise ValueError(f'MODEL.DTYPE must be one of '
                             f'{sorted(layers.DTYPES)}, got {dtype!r}')
        dtype = layers.DTYPES[dtype]
    head_cfg = HeadConfig.from_yaml(model_cfg['HEAD'], model_cfg['BACKBONE'])
    backbone = build_backbone(model_cfg['BACKBONE'])
    model = layers.set_compute_dtype(AssembledModel(backbone, head_cfg),
                                     dtype)
    emit = _emit_images_for(head_cfg)
    # The blob occlusion applies to train and test pairs alike
    # (``bihome_tpu/config.py:98-115``); check_ported refuses it until the
    # port has it.
    blob_kw = {}
    if config['DATA'].get('AUGMENT_BLOB_POROSITY') is not None:
        blob_kw['blob_porosity'] = float(
            config['DATA']['AUGMENT_BLOB_POROSITY'])
        blob_kw['blobiness'] = float(
            config['DATA'].get('AUGMENT_BLOBINESS', 1.0))
    pair_spec = dataclasses.replace(
        PairSpec.from_transforms(config['DATA']['TRANSFORMS'], emit),
        warp_dtype=('bfloat16' if dtype == torch.bfloat16 else 'float32'),
        **blob_kw)
    test_pair_spec = dataclasses.replace(
        PairSpec.from_transforms(config['DATA'].get(
            'TEST_TRANSFORM', config['DATA']['TRANSFORMS']), emit),
        **blob_kw)
    check_ported(pair_spec)
    check_ported(test_pair_spec)
    return BuiltModel(model=model, head_cfg=head_cfg, pair_spec=pair_spec,
                      test_pair_spec=test_pair_spec,
                      loss_name=config['SOLVER']['LOSS'], config=config,
                      dtype=dtype)


def solver_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """Optimizer settings of the SOLVER section (ref:
    bihome_tpu/config.py:122-134)."""
    solver = config['SOLVER']
    if solver.get('OPTIMIZER', 'Adam') != 'Adam':
        raise ValueError(f"not ported yet: optimizer {solver['OPTIMIZER']}")
    return dict(
        lr=float(solver['LR']),
        milestones=solver.get('MILESTONES', []),
        decay=float(solver.get('LR_DECAY', 0.1)),
        beta1=float(solver.get('MOMENTUM_1', 0.9)),
        beta2=float(solver.get('MOMENTUM_2', 0.999)),
        weight_decay=float(solver.get('L2_WEIGHT_DECAY', 0.0)),
        gradient_clip=float(solver.get('GRADIENT_CLIP', -1)),
    )
