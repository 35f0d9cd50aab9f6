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

Across ranks (``bihome_torch.parallel``, world R > 1) each rank runs the
step on its B/R slice of the global batch B, which JAX's
``compile_for_mesh`` step shards the same way (``trainer.py:285-292``):

* every rank draws the global batch's pair, photometric and DSAC draws
  from the same seeded generators, in the one-process step's order, and
  keeps its rows (the ``rows`` of ``pipeline.generate_pairs`` and of the
  DSAC draw), so R ranks at B take the one-process step at B;
* the batch norms and the PF head normalise by the global batch's
  statistics (``models/norm.py``, ``ops/fused_head.py``);
* after the backward the gradients are summed over the ranks in one
  collective (``parallel.mesh.all_reduce_grads``) and scaled to the
  gradient of the global loss: the biHomE and triplet losses and
  CosineDistance sum over the batch (scale 1), the tensor losses average
  (scale 1/R; :func:`loss_scale`); ``g_norm`` reads the summed
  gradients, as JAX's does. Parameters without a gradient (the score CNN
  under the double-line loss, the frozen extractor) take no part, so no
  rank waits for them;
* :func:`global_metrics` gives the metrics JAX logs from its replicated
  values, those of the global batch.

The device pool is either whole on every rank, which draws the global
batch's indices and keeps its slice, or (``pool_shard``) sharded: rank r
holds its rows and draws its B/R indices from its own generator
(:func:`draw_pool_batch`, ``trainer.py:127-170``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bihome_torch import geometry
from bihome_torch.data import pipeline
from bihome_torch.parallel import mesh
from bihome_torch.parallel.dist_util import get_rank, get_world_size
from bihome_torch.training import losses
from bihome_torch.training.train_state import Optimizer

Tensor = torch.Tensor


def _metrics(loss_name: str, out: Dict, suffix: str) -> Dict[str, Tensor]:
    metrics = {f'loss/{suffix}': losses.compute_loss(loss_name, out).detach()}
    if out.get('delta_gt') is not None:
        metrics[f'mace/{suffix}'] = geometry.mace(
            out['delta_gt'], out['delta_hat'].detach())
    return metrics


# Losses that average over the batch; the others sum over it.
MEAN_LOSSES = ('MSELoss', 'L1Loss', 'SmoothL1Loss')


def loss_scale(loss_name: str, world: int) -> float:
    """The factor that turns the sum over the ranks of their gradients
    into the gradient of the global batch's loss: 1/R for a loss that
    averages over the batch, 1 for one that sums over it."""
    return 1.0 / world if loss_name in MEAN_LOSSES else 1.0


# How a metric of the global batch follows from the ranks' (JAX logs its
# replicated values, the global batch's): the per-sample sums over the
# batch (the loss terms ln1-ln3, the homographies' distances h/*) add up,
# the least per-sample mask sum (loss_den/*) is the least of the ranks',
# loss/train follows its loss (:func:`loss_scale`), and the means (MACE,
# l1-l3, the feature means) and the values equal on every rank (g_norm,
# lr) average.
SUM_METRICS = ('loss_comp/ln', 'h/')
MIN_METRICS = ('loss_den/',)


def global_metrics(metrics: Dict[str, Tensor], loss_name: str
                   ) -> Dict[str, Tensor]:
    """The metrics of the global batch from each rank's, as the rules
    above give them (two collectives at most); the metrics themselves in
    one process."""
    world = get_world_size()
    if world == 1:
        return metrics
    device = metrics['loss/train'].device
    values = {k: torch.as_tensor(v, dtype=torch.float32).reshape(())
              .to(device) for k, v in metrics.items()}
    least = [k for k in values if k.startswith(MIN_METRICS)]
    summed = [k for k in values if k not in least]

    def scale(key):
        if key == 'loss/train':
            return loss_scale(loss_name, world)
        return 1.0 if key.startswith(SUM_METRICS) else 1.0 / world
    out, = mesh.sum_over_ranks(torch.stack([values[k] for k in summed]))
    reduced = {k: v * scale(k) for k, v in zip(summed, out.unbind())}
    if least:
        out = mesh.min_over_ranks(torch.stack([values[k] for k in least]))
        reduced.update(zip(least, out.unbind()))
    return {k: reduced[k] for k in metrics}


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
    (``pipeline.generate_pairs``), ``uniforms`` the DSAC draws, each this
    rank's rows. Across R ranks ``images`` are this rank's B/R rows of the
    global batch, and the draws that are not injected are the global
    batch's rows of this rank (``rows``)."""
    model.train()
    world = get_world_size()
    local = images.shape[0]
    rows = (get_rank() * local, world * local) if world > 1 else None
    with torch.no_grad():
        batch = pipeline.generate_pairs(images, spec, datagen_generator,
                                        corners, delta, photometric_params,
                                        rows=rows)
    optimizer.zero_grad()
    out = model(batch, uniforms=uniforms, generator=dsac_generator,
                rows=rows)
    loss = losses.compute_loss(loss_name, out)
    loss.backward()
    mesh.all_reduce_grads(optimizer.params, loss_scale(loss_name, world))
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
                    generator: torch.Generator,
                    pool_shard: bool = False) -> Tensor:
    """B pool rows drawn uniformly with replacement: the indices from
    ``generator``, which lives on the pool's device (no host copy), then
    one gather there. Across R ranks, this rank's B/R rows: the global
    batch's indices sliced, or with ``pool_shard`` B/R indices into this
    rank's shard of the pool (``pool``), from this rank's generator
    (``local_gather``, ``trainer.py:161-165``)."""
    world = get_world_size()
    lo, hi = mesh.shard_range(batch_size, world, get_rank())
    count = hi - lo if pool_shard else batch_size
    idx = torch.randint(0, pool.shape[0], (count,),
                        generator=generator, device=pool.device)
    if not pool_shard:
        idx = idx[lo:hi]
    return pipeline.take_images(pool, idx)


def pool_train_block(model: torch.nn.Module, optimizer: Optimizer,
                     pool: Tensor, steps: int, batch_size: int,
                     spec: pipeline.PairSpec, loss_name: str,
                     draw_generator: torch.Generator,
                     datagen_generator: Optional[torch.Generator] = None,
                     dsac_generator: Optional[torch.Generator] = None,
                     pool_shard: bool = False
                     ) -> Tuple[Dict[str, Tensor], List[Tensor]]:
    """``steps`` train steps on batches drawn from a device-resident pool
    (``make_pool_train_step``): each step draws its B indices with
    :func:`draw_pool_batch` (across ranks, this rank's B/R), then runs
    :func:`train_step`. Nothing in it waits for the device. Returns the
    last step's metrics and each step's loss (device tensors; this rank's
    across ranks)."""
    losses = []
    for _ in range(steps):
        metrics = train_step(model, optimizer,
                             draw_pool_batch(pool, batch_size,
                                             draw_generator, pool_shard),
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
    as :func:`pool_train_block` draws them in one process
    (``make_pool_eval_step``, ``trainer.py:194-210``). Across ranks every
    rank evaluates every batch, as JAX's replicated eval block does, so
    the means are the same on every rank."""
    sums: Dict[str, Tensor] = {}
    for _ in range(steps):
        idx = torch.randint(0, pool.shape[0], (batch_size,),
                            generator=draw_generator, device=pool.device)
        m = eval_step(model, pipeline.take_images(pool, idx),
                      spec, loss_name, datagen_generator, dsac_generator)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v
    return {k: v / steps for k, v in sums.items()}
