"""One training step and one eval step (counterparts of
``bihome_tpu/training/trainer.py:47-98`` and ``:240-262``), and the
device-pool blocks built on them (``make_pool_train_step``,
``make_pool_eval_step``, ``pick_steps_per_call``, ``:126-237``).

The train step, in the JAX step's order: synthesize a batch of pairs on
the device from uint8 images (``generate_pairs``, with the photometric
distortion where the spec asks for it), run the model in training mode
(batch-statistics BN, then the head: DSAC in both directions with
gradients flowing for zeng-biHomE, the regressed deltas otherwise), the
loss (the head's own biHomE loss, or SOLVER.LOSS on its ground_truth and
network_output), backward, then one optimizer update. The frozen
auxiliary extractor gets no parameter gradients (its parameters do not
require grad), while input gradients still flow through it. Randomness
comes from two generators, one for the pair draws and one for the DSAC
draws (drawn from only by heads with DSAC), or is injected (tests).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

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
               uniforms: Optional[Sequence[Tensor]] = None,
               photometric_params: Optional[Sequence] = None
               ) -> Dict[str, Tensor]:
    """images [B,H,W,3] (uint8 pool rows, on the model's device) -> the
    metrics dict with the JAX keys (loss/train, g_norm/value, lr/value,
    mace/train and the head's metrics), as device tensors. ``corners``,
    ``delta`` and ``photometric_params`` inject the pair draws
    (``pipeline.generate_pairs``), ``uniforms`` the DSAC draws."""
    model.train()
    with torch.no_grad():
        batch = pipeline.generate_pairs(images, spec, datagen_generator,
                                        corners, delta, photometric_params)
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


def pick_steps_per_call(steps_per_epoch: int, log_step: int,
                        max_steps: int = 25) -> int:
    """Largest divisor of both epoch length and logging interval <= max
    (``trainer.py:229-237``)."""
    g = math.gcd(max(steps_per_epoch, 1), max(log_step, 1))
    for d in range(min(max_steps, g), 0, -1):
        if g % d == 0:
            return d
    return 1


def draw_pool_batch(pool: Tensor, batch_size: int,
                    generator: torch.Generator) -> Tensor:
    """B pool rows drawn uniformly with replacement: the indices from
    ``generator``, which lives on the pool's device (no host copy), then
    one gather there."""
    idx = torch.randint(0, pool.shape[0], (batch_size,),
                        generator=generator, device=pool.device)
    return pipeline.take_images(pool, idx)


def pool_train_block(model: torch.nn.Module, optimizer: Optimizer,
                     pool: Tensor, steps: int, batch_size: int,
                     spec: pipeline.PairSpec, loss_name: str,
                     draw_generator: torch.Generator,
                     datagen_generator: Optional[torch.Generator] = None,
                     dsac_generator: Optional[torch.Generator] = None
                     ) -> Tuple[Dict[str, Tensor], List[Tensor]]:
    """``steps`` train steps on batches drawn from a device-resident pool
    (``make_pool_train_step`` without the mesh): each step draws its B
    indices with :func:`draw_pool_batch`, then runs :func:`train_step`.
    Nothing in it waits for the device. Returns the last step's metrics
    and each step's loss (device tensors)."""
    losses = []
    for _ in range(steps):
        metrics = train_step(model, optimizer,
                             draw_pool_batch(pool, batch_size,
                                             draw_generator),
                             spec, loss_name, datagen_generator,
                             dsac_generator)
        losses.append(metrics['loss/train'])
    return metrics, losses


def pool_eval(model: torch.nn.Module, pool: Tensor, steps: int,
              batch_size: int, spec: pipeline.PairSpec, loss_name: str,
              draw_generator: torch.Generator,
              datagen_generator: Optional[torch.Generator] = None,
              dsac_generator: Optional[torch.Generator] = None
              ) -> Dict[str, Tensor]:
    """The mean eval metrics of ``steps`` batches drawn from a device pool
    as :func:`pool_train_block` draws them (``make_pool_eval_step``,
    ``trainer.py:194-210``)."""
    sums: Dict[str, Tensor] = {}
    for _ in range(steps):
        m = eval_step(model, draw_pool_batch(pool, batch_size,
                                             draw_generator),
                      spec, loss_name, datagen_generator, dsac_generator)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v
    return {k: v / steps for k, v in sums.items()}
