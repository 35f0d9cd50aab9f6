"""The plain reference's model, training step and serving call.

Plain float32 torch: the model of :mod:`benchmark.reference.heads.assembled`
with plain layers in place of every hand-written kernel (the PF head as
four layers, the decoder's deconv and 3x3 conv as two, the warps as a
4-tap gather, the loss tail and every backward by autograd), and Adam
written out. It imports nothing of the program. The caller hands it the
weights, the pool and the generators' states that it handed the program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.reference import geometry
from benchmark.reference.data.pipeline import PairSpec, generate_pairs
from benchmark.reference.heads.assembled import AssembledModel, needs_dsac
from benchmark.reference.heads.config import HeadConfig
from benchmark.reference.models.backbones import build_backbone
from benchmark.reference.training import losses

Tensor = torch.Tensor


@dataclasses.dataclass
class Built:
    model: AssembledModel
    head_cfg: HeadConfig
    pair_spec: PairSpec
    loss_name: str
    solver: Dict[str, Any]


def build(config: Dict[str, Any]) -> Built:
    """The float32 model and the training pair spec of a reference-schema
    config (MODEL, DATA, SOLVER sections)."""
    model_cfg = config['MODEL']
    if model_cfg.get('DTYPE', 'float32') != 'float32':
        raise ValueError('the reference computes in float32 only')
    head_cfg = HeadConfig.from_yaml(model_cfg['HEAD'], model_cfg['BACKBONE'])
    model = AssembledModel(build_backbone(model_cfg['BACKBONE']), head_cfg)
    data = config['DATA']
    if data.get('AUGMENT_BLOB_POROSITY'):
        raise ValueError('the blob occlusion is not in this reference')
    spec = PairSpec.from_transforms(data['TRANSFORMS'])
    return Built(model, head_cfg, spec, config['SOLVER']['LOSS'],
                 config['SOLVER'])


class Adam:
    """Adam with bias correction (eps 1e-8) and the per-step MultiStepLR of
    SOLVER: update k uses LR * LR_DECAY ** (milestones <= k). No clip and
    no weight decay: the configs set neither."""

    def __init__(self, named: Sequence[Tuple[str, torch.nn.Parameter]],
                 solver: Dict[str, Any]):
        if float(solver.get('GRADIENT_CLIP', -1)) > 0 or float(
                solver.get('L2_WEIGHT_DECAY', 0.0) or 0.0):
            raise ValueError('the reference Adam has no clip and no decay')
        self.named = list(named)
        self.lr = float(solver['LR'])
        self.milestones = sorted(int(m) for m in solver.get('MILESTONES', []))
        self.decay = float(solver.get('LR_DECAY', 0.1))
        self.b1 = float(solver.get('MOMENTUM_1', 0.9))
        self.b2 = float(solver.get('MOMENTUM_2', 0.999))
        self.m = {n: torch.zeros_like(p) for n, p in self.named}
        self.v = {n: torch.zeros_like(p) for n, p in self.named}
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        k = self.count
        lr = self.lr * self.decay ** sum(1 for m in self.milestones if k >= m)
        t = k + 1
        for name, p in self.named:
            if p.grad is None:
                continue
            g = p.grad
            self.m[name].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[name] / (1 - self.b1 ** t)
            v_hat = self.v[name] / (1 - self.b2 ** t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + 1e-8))
        self.count += 1


def trainable(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def train_steps(built: Built, pool: Tensor, batch_size: int, steps: int,
                draws: torch.Generator, datagen: torch.Generator,
                dsac: torch.Generator) -> Dict[str, Any]:
    """``steps`` training steps from the model's present weights: each
    draws B pool rows with replacement (``draws``, on the pool's device),
    synthesizes the pairs (``datagen``), runs the model in training mode
    (DSAC draws from ``dsac``), the loss, autograd and Adam. Returns each
    step's loss, each trainable leaf's gradient norm at the first step and
    each leaf's norm of change over all the steps (the first step's
    weights against the last's)."""
    model = built.model.train()
    named = trainable(model)
    before = {n: p.detach().clone() for n, p in named}
    adam = Adam(named, built.solver)
    out: Dict[str, Any] = {'loss': [], 'grad_norm': {}, 'change_norm': {}}
    for k in range(steps):
        idx = torch.randint(0, pool.shape[0], (batch_size,), generator=draws,
                            device=pool.device)
        with torch.no_grad():
            batch = generate_pairs(pool.index_select(0, idx), built.pair_spec,
                                   datagen)
        for _, p in named:
            p.grad = None
        head_out = model(batch, generator=dsac)
        loss = losses.compute_loss(built.loss_name, head_out)
        loss.backward()
        if k == 0:
            out['grad_norm'] = {n: float(torch.linalg.vector_norm(p.grad))
                                for n, p in named if p.grad is not None}
        adam.step()
        out['loss'].append(float(loss.detach()))
    out['change_norm'] = {n: float(torch.linalg.vector_norm(p.detach()
                                                            - before[n]))
                          for n, p in named}
    return out


def serving_uniforms(built: Built, rows: int, rng_seed: int
                     ) -> Optional[List[Tensor]]:
    """The serving call's DSAC draws for ``rows`` samples from ``rng_seed``
    (CPU generator): the 1->2 field's [rows, n * points], then the 2->1
    field's with DSAC_PREDICT_BIDIRECTIONAL; None for a head without
    DSAC."""
    cfg = built.head_cfg
    if not needs_dsac(cfg):
        return None
    if cfg.dsac_point_sampling != 'reference-weighted':
        raise ValueError('the serving draws are reference-weighted only')
    gen = torch.Generator().manual_seed(rng_seed)
    k = cfg.hypothesis_no * cfg.points_per_hypothesis
    draws = [torch.rand((rows, k), generator=gen)]
    if cfg.dsac_predict_bidirectional and len(cfg.pf_keys) > 1:
        draws.append(torch.rand((rows, k), generator=gen))
    return draws


@torch.no_grad()
def predict(built: Built, patch_1: Tensor, patch_2: Tensor,
            uniforms: Optional[Sequence[Tensor]]) -> Tensor:
    """delta_hat [B,4,2] of the eval-mode model on NHWC patches, the
    corners at the patch frame; ``uniforms`` rows beyond B are unused."""
    model = built.model.eval()
    b, ps = patch_1.shape[0], patch_1.shape[1]
    corners = geometry.image_corners(ps, ps, batch_size=b,
                                     device=patch_1.device)
    batch = {'patch_1': patch_1, 'patch_2': patch_2, 'corners': corners}
    if uniforms is not None:
        uniforms = [u[:b].to(patch_1.device) for u in uniforms]
    return model.predict_delta(batch, uniforms=uniforms).reshape(b, 4, 2)
