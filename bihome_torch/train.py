"""Train entry point of the port (counterpart of ``train.py:44-319`` for the
synthetic, non-clevr, streamed-batch case).

    python -m bihome_torch.train --config_file X.yaml [--synthetic]
        [--steps N] [--batch_size B] [--epochs E] [--set K=V]
        [--image_size W H] [--device cuda|cpu]

Reads the same reference-schema YAML. Each epoch draws
TRAIN_SAMPLES_PER_EPOCH images (capped by ``--steps`` x batch) with the
seeded epoch sampler from the synthetic pool, which lives on the device;
each step synthesizes its pairs on the device and runs
``training.trainer.train_step`` (DoubleLine backbone in training mode,
DSAC both ways, the biHomE loss, Adam with per-step MultiStepLR). Every
LOGGING.STEP steps the step's metrics go to
``<LOGGING.DIR>/metrics.jsonl``; at each epoch's end a checkpoint
``<LOGGING.DIR>/model_<step>.pth`` in the reference layout
(``{"model": {"0.<backbone key>": ...}, "optimizer": ..., "step": ...}``,
which ``bihome_torch.eval --torch_ckpt`` reads) is written and the test
loss and MACE over TEST_SAMPLES_PER_EPOCH (capped likewise) are logged.

The frozen auxiliary extractor loads from MODEL.HEAD.AUXILIARY_RESNET_PATH
when it names an ``.npz`` that exists (``aux_*.npz``); otherwise it and
the backbone come from a fixed seed. Runs on ``cuda`` unless ``--device
cpu`` is given, and raises without a card; TF32 is off. Resume, real
datasets and photometric distortion are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bihome_torch import config as config_lib
from bihome_torch.data import datasets
from bihome_torch.device import resolve_device
from bihome_torch.models import backbones, weights
from bihome_torch.training import trainer
from bihome_torch.training.metrics import MetricsWriter
from bihome_torch.training.train_state import Optimizer
from bihome_torch.utils import aux_store

INIT_SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--steps', type=int, default=0,
                        help='cap steps per epoch (and eval batches)')
    parser.add_argument('--epochs', type=int, default=0)
    parser.add_argument('--batch_size', type=int, default=0)
    parser.add_argument('--image_size', type=int, nargs=2,
                        default=(320, 240))
    parser.add_argument('--set', action='append', default=[],
                        metavar='KEY=VALUE', help='dotted config override')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=('cuda', 'cpu'))
    return parser.parse_args(argv)


def init_model(built: config_lib.BuiltModel) -> List[str]:
    """Seeded init of the backbone and the extractor, then the extractor's
    weights from MODEL.HEAD.AUXILIARY_RESNET_PATH when it names an existing
    ``.npz``. Returns the messages to print."""
    model = built.model
    gen = torch.Generator().manual_seed(INIT_SEED)
    backbones.init_weights(model.backbone, gen)
    backbones.init_weights(model.auxiliary_resnet, gen)
    path = built.config['MODEL']['HEAD'].get('AUXILIARY_RESNET_PATH')
    if not (path and path.endswith('.npz') and os.path.exists(path)):
        return ['Auxiliary resnet: seeded init (no .npz path given)']
    state, dropped = aux_store.state_dict_from_aux(
        aux_store.load_aux_npz(path),
        built.head_cfg.auxiliary_resnet_output_layer)
    weights.load_state_dict(model.auxiliary_resnet, state)
    msg = f'Auxiliary resnet (npz) loaded from {path}'
    if dropped:
        msg += f' (pruned beyond model depth: {", ".join(dropped)})'
    return [msg]


def checkpoint(model: torch.nn.Module, optimizer: Optimizer,
               step: int) -> Dict[str, Any]:
    """The reference checkpoint layout: nn.Sequential(backbone, head) keys,
    the backbone under '0.' and the head's extractor under '1.'."""
    state = {f'0.{k}': v.detach().cpu()
             for k, v in model.backbone.state_dict().items()}
    state.update({f'1.auxiliary_resnet.{k}': v.detach().cpu()
                  for k, v in model.auxiliary_resnet.state_dict().items()})
    return {'model': state, 'optimizer': optimizer.state_dict(),
            'step': step}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the training; returns what it measured plus the model (for
    callers that check it further): per-step host ms (each step ended by a
    device synchronisation), per-step losses, the initial state dict (on
    the CPU), the checkpoint path and the logged records."""
    args = parse_args(argv)
    if not args.synthetic:
        raise ValueError('not ported yet: real datasets; pass --synthetic')
    device = resolve_device(args.device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = config_lib.load_config(args.config_file)
    config_lib.apply_overrides(config, args.set)
    sampler_cfg = config['DATA']['SAMPLER']
    log_cfg = config['LOGGING']
    batch_size = args.batch_size or sampler_cfg['BATCH_SIZE']
    epochs = args.epochs or config['SOLVER']['NUM_EPOCHS']
    steps_per_epoch = sampler_cfg['TRAIN_SAMPLES_PER_EPOCH'] // batch_size
    test_steps = sampler_cfg['TEST_SAMPLES_PER_EPOCH'] // batch_size
    if args.steps:
        steps_per_epoch = min(steps_per_epoch, args.steps)
        test_steps = min(test_steps, args.steps)
    train_seed = int(sampler_cfg.get('TRAIN_SEED', 0) or 0)
    test_seed = int(sampler_cfg.get('TEST_SEED', 0) or 0)
    log_step = int(log_cfg.get('STEP', 100))
    verbose = bool(log_cfg.get('VERBOSE', False))

    built = config_lib.build_model(config)
    for line in init_model(built):
        print(line)
    model = built.model.to(device)
    initial_state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = Optimizer(trainable, **config_lib.solver_kwargs(config))
    print(f'Number of params: {sum(p.numel() for p in trainable)} trainable, '
          f'{sum(p.numel() for p in model.parameters())} in all')

    image_size = tuple(args.image_size)
    train_ds = datasets.SyntheticDataset(image_size=image_size, seed=0)
    test_ds = datasets.SyntheticDataset(image_size=image_size, seed=1)
    train_pool = torch.from_numpy(train_ds.pool).to(device)
    test_pool = torch.from_numpy(test_ds.pool).to(device)
    train_sampler = datasets.EpochSampler(
        len(train_ds), steps_per_epoch * batch_size, random_seed=train_seed)
    test_sampler = datasets.EpochSampler(
        len(test_ds), test_steps * batch_size, random_seed=test_seed)
    datagen_gen = torch.Generator().manual_seed(train_seed)
    dsac_gen = torch.Generator().manual_seed(train_seed + 1)

    log_dir = log_cfg['DIR']
    writer = MetricsWriter(log_dir)
    step = 0
    step_ms: List[float] = []
    losses: List[torch.Tensor] = []
    records: List[Dict[str, float]] = []
    ckpt_path = None
    for epoch in range(epochs):
        print(f'Training epoch: {epoch}')
        t_epoch = time.time()
        order = torch.from_numpy(train_sampler.epoch_indices().reshape(
            steps_per_epoch, batch_size)).to(device)
        for i in range(steps_per_epoch):
            start = time.perf_counter()
            metrics = trainer.train_step(
                model, optimizer, train_pool[order[i]], built.pair_spec,
                built.loss_name, datagen_gen, dsac_gen)
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            step_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(metrics['loss/train'])
            step += 1
            if step % log_step == 0:
                rec = writer.scalars(step, metrics)
                records.append(rec)
                if verbose:
                    print(f'Epoch: {epoch} step: {step} '
                          f'loss: {rec["loss/train"]:.5f}')
        ckpt_path = os.path.join(log_dir, f'model_{step:06d}.pth')
        torch.save(checkpoint(model, optimizer, step), ckpt_path)
        print(f'Epoch {epoch} done in {time.time() - t_epoch:.1f}s')

        if test_steps > 0:
            print(f'Testing epoch: {epoch}')
            order = torch.from_numpy(test_sampler.epoch_indices().reshape(
                test_steps, batch_size)).to(device)
            gen = torch.Generator().manual_seed(test_seed)
            dgen = torch.Generator().manual_seed(test_seed + 1)
            sums: Dict[str, torch.Tensor] = {}
            for i in range(test_steps):
                m = trainer.eval_step(model, test_pool[order[i]],
                                      built.test_pair_spec, built.loss_name,
                                      gen, dgen)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + v
            rec = writer.scalars((epoch + 1) * steps_per_epoch,
                                 {k: v / test_steps for k, v in sums.items()})
            records.append(rec)
            print(f'Test loss: {rec["loss/test"]}  '
                  f'test mace: {rec.get("mace/test")}')
    writer.close()
    print('DONE!')
    timed = step_ms[1:] if len(step_ms) > 1 else step_ms
    return {'model': model, 'optimizer': optimizer, 'step': step,
            'step_ms': step_ms, 'median_step_ms': float(np.median(timed)),
            'losses': torch.stack(losses).cpu() if losses else None,
            'initial_state': initial_state, 'checkpoint': ckpt_path,
            'records': records, 'batch_size': batch_size,
            'log_dir': log_dir, 'built': built}


if __name__ == '__main__':
    main()
