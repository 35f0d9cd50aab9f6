"""One training step and one eval step (counterparts of
``bihome_tpu/training/trainer.py:47-98`` and ``:240-262``).

The train step, in the JAX step's order: synthesize a batch of pairs on
the device from uint8 images (``generate_pairs``), run the model in
training mode (batch-statistics BN, DSAC in both directions with gradients
flowing, the biHomE loss), backward, then one optimizer update. The frozen
auxiliary extractor gets no parameter gradients (its parameters do not
require grad), while input gradients still flow through it. Randomness
comes from two generators, one for the pair draws and one for the DSAC
draws, or is injected (tests).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from bihome_torch import geometry
from bihome_torch.data import pipeline
from bihome_torch.training import losses
from bihome_torch.training.train_state import Optimizer

Tensor = torch.Tensor


def _metrics(loss_name: str, out: Dict, suffix: str) -> Dict[str, Tensor]:
    metrics = {f'loss/{suffix}': losses.compute_loss(loss_name, out).detach()}
    if out.get('delta_gt') is not None:
        metrics[f'mace/{suffix}'] = geometry.mace(
            out['delta_gt'], out['delta_hat'].detach())
    return metrics


def train_step(model: torch.nn.Module, optimizer: Optimizer,
               images: Tensor, spec: pipeline.PairSpec, loss_name: str,
               datagen_generator: Optional[torch.Generator] = None,
               dsac_generator: Optional[torch.Generator] = None,
               corners: Optional[Tensor] = None,
               delta: Optional[Tensor] = None,
               uniforms: Optional[Sequence[Tensor]] = None
               ) -> Dict[str, Tensor]:
    """images [B,H,W,3] (uint8 pool rows, on the model's device) -> the
    metrics dict with the JAX keys (loss/train, g_norm/value, lr/value,
    mace/train and the head's metrics), as device tensors."""
    model.train()
    with torch.no_grad():
        batch = pipeline.generate_pairs(images, spec, datagen_generator,
                                        corners, delta)
    optimizer.zero_grad()
    out = model(batch, uniforms=uniforms, generator=dsac_generator)
    loss = losses.compute_loss(loss_name, out)
    loss.backward()
    g_norm = optimizer.global_norm()
    lr = optimizer.step()
    metrics = _metrics(loss_name, out, 'train')
    metrics.update({'g_norm/value': g_norm,
                    'lr/value': torch.tensor(lr, dtype=torch.float32)})
    metrics.update(out.get('metrics', {}))
    return metrics


@torch.no_grad()
def eval_step(model: torch.nn.Module, images: Tensor,
              spec: pipeline.PairSpec, loss_name: str,
              datagen_generator: Optional[torch.Generator] = None,
              dsac_generator: Optional[torch.Generator] = None
              ) -> Dict[str, Tensor]:
    """The eval_one_epoch body: eval-mode loss and MACE on one batch
    (running-statistics BN; the model is put back in its former mode)."""
    was_training = model.training
    model.eval()
    try:
        batch = pipeline.generate_pairs(images, spec, datagen_generator)
        out = model(batch, generator=dsac_generator)
        return _metrics(loss_name, out, 'test')
    finally:
        model.train(was_training)
