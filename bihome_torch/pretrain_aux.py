"""Self-supervised pretext training of the biHomE loss's frozen extractor
(counterpart of ``tools/pretrain_aux.py``).

    python -m bihome_torch.pretrain_aux --pretext gradcl --steps 1500 \\
        --out aux.npz [--device cuda|cpu]

The biHomE loss compares patches in the feature space of a frozen
resnet34 cut at layer1; the reference loads ImageNet weights. This entry
point trains that stack (conv1/bn1/layer1, through layer2 with ``--layers
2``) on a pretext over the synthetic pool and writes it as the flat flax
``.npz`` (``utils/aux_store.save_aux_npz``) that MODEL.HEAD.
AUXILIARY_RESNET_PATH takes, in the port and in the JAX package. The
pretexts (``--pretext``; ``tools/pretrain_aux.py:14-43`` says more):

* rotnet: the whole resnet34 with a 4-unit ``fc`` predicts which of the
  four rotations (``np.rot90(x, k)`` on H, W) a patch took;
* grad: the features regress the multi-scale intensity and gradient
  pyramid of :func:`bihome_torch.pretrain.targets.grad_targets`;
* gradpi: the photometric-invariant pyramid, from a patch jittered in
  brightness and contrast;
* gradpds: the same target from a clean RGB crop, the input through the
  PDS photometric distortion (max delta 32);
* gradcl: the grad targets of both views plus a dense InfoNCE between
  patch_2 and patch_1 warped by the ground-truth deltas (K3), optionally
  a rex-0 term (``--cl_fine_weight``) and the basin term
  (``--basin_weight``, a second view warped by deltas jittered 0.5-4 px);
* gradpdscl: gradcl on pairs whose two copies each took the PDS
  distortion, with the photometric-invariant targets at weight 0.25.

The flags and their defaults are JAX's (``:493-534``), plus ``--device``
(default cuda: the warps run K3 there). The model computes in bfloat16
with float32 parameters (``models/layers.set_compute_dtype``), Adam at
``--lr`` (``optax.adam``), the BN running statistics updated every step
(flax's momentum and biased variance). Every draw comes from one
``torch.Generator`` seeded by ``--seed`` (:func:`draw`), and
:func:`make_batch` builds a batch from given draws, so a test can hand
JAX the same ones. Steps run in ``--steps // --unroll`` blocks of
``--unroll``, each ended by one synchronisation; every fifth block prints
its last step's loss and accuracy.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bihome_torch import geometry
from bihome_torch.data import photometric, pipeline, synthetic
from bihome_torch.device import resolve_device
from bihome_torch.models import backbones, layers
from bihome_torch.models.resnet import ResNet
from bihome_torch.ops import color
from bihome_torch.pretrain import targets
from bihome_torch.training.train_state import Optimizer
from bihome_torch.utils import aux_store

Tensor = torch.Tensor

PRETEXTS = ('rotnet', 'grad', 'gradpi', 'gradpds', 'gradcl', 'gradpdscl')
POOL_HW = (240, 320)
# The model's initial weights are seeded apart from the draws, as JAX
# initialises from PRNGKey(0) and draws from PRNGKey(--seed).
INIT_SEED = 0


@dataclasses.dataclass(frozen=True)
class Pretext:
    """One pretext's static settings (the flags of ``:493-534``); the
    patch side and rho are JAX's fixed 128 and 32 unless a test cuts
    them."""
    name: str = 'rotnet'
    layers: int = 1
    rich_target: bool = False
    cl_weight: float = 0.3
    cl_fine_weight: float = 0.0
    tau: float = 0.15
    rex: int = 2
    cl_hard_beta: float = 0.0
    basin_weight: float = 0.0
    patch_size: int = 128
    rho: int = 32

    @staticmethod
    def from_args(args: argparse.Namespace) -> 'Pretext':
        return Pretext(args.pretext, args.layers, args.rich_target,
                       args.cl_weight, args.cl_fine_weight, args.tau,
                       args.rex, args.cl_hard_beta, args.basin_weight)

    @property
    def is_cl(self) -> bool:
        return self.name.endswith('cl')

    @property
    def output_layer(self) -> Optional[int]:
        """The extractor's cut: ``--layers`` for the grad pretexts, none
        (the whole resnet34 and its fc) for rotnet (``:274``)."""
        return self.layers if self.name.startswith('grad') else None

    @property
    def stride(self) -> int:
        """Layer k's features have stride 2^(k+1) (``:278``)."""
        return 2 ** (self.layers + 1)

    @property
    def out_dim(self) -> int:
        """... and 64 * 2^(k-1) channels (``:279``)."""
        return 64 * 2 ** (self.layers - 1)

    @property
    def spec(self) -> pipeline.PairSpec:
        """The pair spec: no photometric distortion, except gradpdscl's on
        both copies at max delta 32 (``:283-292``)."""
        pds = self.name == 'gradpdscl'
        return pipeline.PairSpec(
            rho=self.rho, patch_size=self.patch_size,
            photometric_keys=('image_1', 'image_2') if pds else (),
            max_delta=32.0 if pds else 0.0)

    def target(self, x: Tensor) -> Tensor:
        """The distillation target of a view (``:372-375``)."""
        if self.name in ('gradpi', 'gradpds', 'gradpdscl'):
            return targets.grad_targets_pi(x, self.stride, self.out_dim)
        return targets.grad_targets(
            x, self.rich_target and self.is_cl, self.stride, self.out_dim)


def build_model(pretext: Pretext, dtype: torch.dtype = torch.bfloat16,
                seed: int = INIT_SEED) -> ResNet:
    """The pretext's resnet34 (a 1-channel stem; rotnet whole with a
    4-unit fc) computing in ``dtype``, seeded init (``:280-281``)."""
    model = ResNet('resnet34', output_layer=pretext.output_layer,
                   in_channels=1, num_classes=4)
    backbones.init_weights(model, torch.Generator().manual_seed(seed))
    return layers.set_compute_dtype(model, dtype)


def draw(pretext: Pretext, batch: int, pool_size: int,
         generator: torch.Generator,
         image_hw: Tuple[int, int] = POOL_HW) -> Dict[str, Tensor]:
    """One step's draws, on the CPU, in this order: the pool rows 'idx'
    [B]; then for gradpds the crop origins 'ox', 'oy' [B] and the
    distortion 'pd' [B,12]; for the others the corners and deltas [B,4,2]
    (``pipeline.draw_corners_delta_batch``), then rotnet's rotations 'rot'
    [B] in 0..3, gradpi's brightness offsets 'b' in [-0.5, 0.5) and
    contrast factors 'c' in [0.6, 1.5) [B], gradpdscl's distortions 'pd1',
    'pd2' [B,12], and with the basin term each sample's jitter scale 's'
    in [0.5, 4) [B] and its unit jitters 'eps' in [-1, 1) [B,4,2]."""
    h, w = image_hw
    ps = pretext.patch_size
    out = {'idx': torch.randint(0, pool_size, (batch,), generator=generator)}
    if pretext.name == 'gradpds':
        out['ox'] = torch.randint(0, w - ps + 1, (batch,), generator=generator)
        out['oy'] = torch.randint(0, h - ps + 1, (batch,), generator=generator)
        out['pd'] = photometric.draw_photometric_params(batch, 32.0,
                                                        generator)
        return out
    out['corners'], out['delta'] = pipeline.draw_corners_delta_batch(
        batch, image_hw, pretext.spec, generator)
    if pretext.name == 'rotnet':
        out['rot'] = torch.randint(0, 4, (batch,), generator=generator)
    elif pretext.name == 'gradpi':
        out['b'] = torch.rand((batch,), generator=generator) - 0.5
        out['c'] = 0.6 + 0.9 * torch.rand((batch,), generator=generator)
    elif pretext.name == 'gradpdscl':
        out['pd1'], out['pd2'] = (
            photometric.draw_photometric_params(batch, 32.0, generator)
            for _ in range(2))
    if pretext.is_cl and pretext.basin_weight > 0:
        out['s'] = 0.5 + 3.5 * torch.rand((batch,), generator=generator)
        out['eps'] = 2.0 * torch.rand((batch, 4, 2), generator=generator) - 1
    return out


def rotate(x: Tensor, rot: Tensor) -> Tensor:
    """Each square patch of x [B,H,W,C] turned by ``rot`` [B] quarter
    turns counter-clockwise, ``np.rot90(x[b], rot[b])`` on (H, W)
    (``:303-309``)."""
    turned = torch.stack([torch.rot90(x, k, dims=(1, 2)) for k in range(4)],
                         dim=1)
    return turned[torch.arange(x.shape[0], device=x.device), rot]


def make_batch(pretext: Pretext, pool: Tensor, draws: Dict[str, Tensor]
               ) -> Dict[str, Any]:
    """The step's batch from ``draws`` (:func:`draw`'s, any device) and the
    uint8 pool [N,H,W,3] on the device (``make_batch``,
    ``make_grad_batch``, ``make_cl_batch``, ``:296-390``): {'x', 'rot'}
    for rotnet, {'x', 'target'} for grad, gradpi and gradpds; for the cl
    pretexts the aligned views 'w1' (patch_1 warped by the ground truth)
    and 'x2' (patch_2), the support 'valid' [B,H/s,W/s], the targets of
    both views 't_w1', 't_x2', and with the basin term the jittered view
    'w1e' and its support 'valide'."""
    dev = pool.device
    d = {k: v.to(dev) for k, v in draws.items()}
    images = pipeline.take_images(pool, d['idx'])
    ps = pretext.patch_size
    spec = pretext.spec
    if pretext.name == 'gradpds':
        rgb = geometry.crop_integer(images.float(), d['ox'], d['oy'], (ps, ps))

        def std(g):
            return color.standardize(g, spec.standardize_mean,
                                     spec.standardize_std)
        target = pretext.target(std(color.rgb_to_grayscale(rgb)))
        distorted = photometric.apply_photometric(rgb, d['pd'])
        return {'x': std(color.rgb_to_grayscale(distorted)),
                'target': target}
    pairs = pipeline.generate_pairs(
        images, spec, corners=d['corners'], delta=d['delta'],
        photometric_params=(d.get('pd1'), d.get('pd2')))
    if pretext.name == 'rotnet':
        return {'x': rotate(pairs['patch_1'], d['rot']), 'rot': d['rot']}
    if not pretext.is_cl:
        x = pairs['patch_1']
        if pretext.name == 'gradpi':
            jitter = (d['c'].reshape(-1, 1, 1, 1)
                      * (x + d['b'].reshape(-1, 1, 1, 1)))
            return {'x': jitter, 'target': pretext.target(x)}
        return {'x': x, 'target': pretext.target(x)}
    w1, mask = targets.warp_gt(pairs['patch_1'], pairs['delta'])
    out = {'w1': w1, 'x2': pairs['patch_2'],
           'valid': targets.nnavg_pool(mask, pretext.stride)[..., 0],
           't_w1': pretext.target(w1),
           't_x2': pretext.target(pairs['patch_2'])}
    if pretext.basin_weight > 0:
        eps = d['eps'] * d['s'].reshape(-1, 1, 1)
        w1e, maske = targets.warp_gt(pairs['patch_1'], pairs['delta'] + eps)
        out['w1e'] = w1e
        out['valide'] = targets.nnavg_pool(maske, pretext.stride)[..., 0]
    return out


def loss_and_acc(pretext: Pretext, model: ResNet, batch: Dict[str, Any]
                 ) -> Tuple[Tensor, Tensor]:
    """The pretext's loss and its accuracy figure, the model in whatever
    mode it is in (``loss_fn``, ``:405-453``). rotnet: softmax cross
    entropy on the logits in their dtype (optax's formula), acc the
    share of rotations found; grad, gradpi, gradpds: the mean squared
    error to the target, acc 1 - mse / mean(target^2); the cl pretexts:
    distill_w * (the mean of both views' mse) + cl_weight * InfoNCE (+
    cl_fine_weight * InfoNCE at rex 0) - basin_weight * basin ratio, with
    distill_w 0.25 for gradpdscl, acc the InfoNCE accuracy, or the basin
    ratio when that term is on."""
    p = pretext
    if p.is_cl:
        views = [batch['w1'], batch['x2']] + (
            [batch['w1e']] if 'w1e' in batch else [])
        out = model(torch.cat(views).permute(0, 3, 1, 2).contiguous())
        parts = out.permute(0, 2, 3, 1).float().chunk(len(views))
        fw1, f2 = parts[0], parts[1]
        mse = 0.5 * (((fw1 - batch['t_w1']) ** 2).mean()
                     + ((f2 - batch['t_x2']) ** 2).mean())
        nce, acc = targets.dense_infonce(fw1, f2, batch['valid'], p.tau,
                                         p.rex, p.cl_hard_beta)
        distill_w = 0.25 if p.name == 'gradpdscl' else 1.0
        loss = distill_w * mse + p.cl_weight * nce
        if 'w1e' in batch:
            ratio = targets.basin_ratio(fw1, parts[2], f2, batch['valid'],
                                        batch['valide'])
            loss = loss - p.basin_weight * ratio
            acc = ratio
        if p.cl_fine_weight > 0:
            nce_fine, _ = targets.dense_infonce(fw1, f2, batch['valid'],
                                                p.tau, 0, p.cl_hard_beta)
            loss = loss + p.cl_fine_weight * nce_fine
        return loss, acc
    out = model(batch['x'].permute(0, 3, 1, 2).contiguous())
    if p.name.startswith('grad'):
        target = batch['target']
        loss = ((out.permute(0, 2, 3, 1).float() - target) ** 2).mean()
        return loss, 1.0 - loss / (target ** 2).mean()
    rot = batch['rot']
    z = out - out.max(dim=-1, keepdim=True).values.detach()
    ce = torch.log(torch.exp(z).sum(dim=-1)) - z.gather(-1, rot[:, None])[:, 0]
    acc = (out.argmax(dim=-1) == rot).float().mean()
    return ce.mean(), acc


def train_step(pretext: Pretext, model: ResNet, optimizer,
               batch: Dict[str, Any]) -> Tuple[Tensor, Tensor]:
    """One step in training mode (batch statistics; the running ones
    updated): the loss's gradient, then Adam. Returns (loss, acc),
    detached device tensors."""
    model.train()
    optimizer.zero_grad()
    loss, acc = loss_and_acc(pretext, model, batch)
    loss.backward()
    optimizer.step()
    return loss.detach(), torch.as_tensor(acc).detach()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--steps', type=int, default=1500)
    p.add_argument('--unroll', type=int, default=20,
                   help='steps a block, ended by one synchronisation')
    p.add_argument('--batch', type=int, default=256)
    p.add_argument('--pool', type=int, default=256)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', type=str, default='aux_rotnet.npz')
    p.add_argument('--cl_weight', type=float, default=0.3,
                   help='weight of the dense InfoNCE term (cl pretexts)')
    p.add_argument('--cl_fine_weight', type=float, default=0.0,
                   help='weight of an additional rex=0 InfoNCE term')
    p.add_argument('--tau', type=float, default=0.15,
                   help='InfoNCE temperature (cl pretexts)')
    p.add_argument('--basin_weight', type=float, default=0.0,
                   help='weight of the basin-sharpening ratio term')
    p.add_argument('--rich_target', action='store_true',
                   help='richer grad distill target of the cl pretexts '
                        '(diagonal derivatives + Laplacian per scale)')
    p.add_argument('--cl_hard_beta', type=float, default=0.0,
                   help='hard-negative weighting exponent of the InfoNCE '
                        'terms; 0 = uniform negatives')
    p.add_argument('--layers', type=int, default=1, choices=(1, 2),
                   help='truncation of the trained extractor: 1 = conv1/'
                        'bn1/layer1 (stride 4, 64 channels), 2 = + layer2 '
                        '(stride 8, 128 channels; use with MODEL.HEAD.'
                        'AUXILIARY_RESNET_OUTPUT_LAYER=2)')
    p.add_argument('--rex', type=int, default=2,
                   help='neighbour-exclusion Chebyshev radius in feature px')
    p.add_argument('--pretext', choices=PRETEXTS, default='rotnet')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train and save; returns the losses and accuracy figures of every
    step (CPU tensors), the ms per step of each block (host time, each
    block ended by a synchronisation), their median over the blocks after
    the first, the peak memory allocated on a card (GB, else None), the
    state dict before the first step (CPU), the model, the modules
    written and the parsed arguments."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    pretext = Pretext.from_args(args)
    model = build_model(pretext).to(device)
    initial_state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
    optimizer = Optimizer(model.parameters(), lr=args.lr)
    pool = torch.from_numpy(synthetic.make_image_pool(
        args.pool, *POOL_HW, seed=args.seed)).to(device)
    generator = torch.Generator().manual_seed(args.seed)
    losses, accs, block_ms = [], [], []
    for blk in range(args.steps // args.unroll):
        begin = time.perf_counter()
        for _ in range(args.unroll):
            draws = draw(pretext, args.batch, args.pool, generator)
            with torch.no_grad():
                batch = make_batch(pretext, pool, draws)
            loss, acc = train_step(pretext, model, optimizer, batch)
            losses.append(loss)
            accs.append(acc)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        block_ms.append((time.perf_counter() - begin) * 1e3 / args.unroll)
        if blk % 5 == 0:
            print(f'step {blk * args.unroll}: loss={float(loss):.4f} '
                  f'acc={float(acc):.3f}', flush=True)
    aux_store.save_aux_npz(args.out, model.state_dict())
    with np.load(args.out) as data:
        written = {k.split('/')[1].split('_')[0] for k in data.files}
    kept = [m for m in ('conv1', 'bn1', 'layer1', 'layer2') if m in written]
    print(f'Saved aux extractor ({"/".join(kept)}) to {args.out}')
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == 'cuda' else None)
    timed = block_ms[1:] or block_ms
    return {'losses': torch.stack(losses).float().cpu() if losses else None,
            'accs': torch.stack(accs).float().cpu() if accs else None,
            'block_ms': block_ms,
            'median_step_ms': float(np.median(timed)) if timed else 0.0,
            'peak_gb': peak_gb, 'initial_state': initial_state,
            'model': model, 'kept': kept, 'args': args, 'pretext': pretext}


if __name__ == '__main__':
    main()
