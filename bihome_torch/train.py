"""Train entry point of the port (counterpart of ``train.py:44-384``).

    python -m bihome_torch.train --config_file X.yaml [--synthetic]
        [--steps N] [--batch_size B] [--epochs E] [--set K=V]
        [--image_size W H] [--device cuda|cpu]

Reads the same reference-schema YAML. The images come from the config's
DATA.TRAIN_SPLIT / TEST_SPLIT (``datasets.make_dataset``: an image or
``.npy`` folder, a ``.bhpk`` pack, a CIFAR-10 pickle directory; the
synthetic pool when the path does not exist; for CLEVR-Change,
``clevr_change.ClevrChangeDataset``), with the config's host-side prep
transforms. They stream: each batch is decoded by the loader's producer
thread (the native prefetch ring for a pack) and copied to the card
through pinned memory, the semantics of JAX's ``--feed stream``
(``train.py:293-304``). ``--synthetic`` instead keeps the synthetic pool
on the device and gathers each batch there. Both routes draw the same
indices: each epoch takes TRAIN_SAMPLES_PER_EPOCH images (capped by
``--steps`` x batch) with the epoch sampler seeded by TRAIN_SEED.

Each step synthesizes its pairs on the device (with the PDS photometric
distortion where the config asks for it) and runs
``training.trainer.train_step`` (backbone in training mode, the head and
its loss: zeng-biHomE's DSAC both ways and biHomE loss, detone-biHomE's
biHomE loss on the regressed deltas, the NoOp head's MSE or L1 on them or
zeng-orig's SmoothL1 on the perspective field, the PhotometricHead's L1
on the warped full image, the TripletHead's loss; Adam with per-step
MultiStepLR). For CLEVR-Change (DATA.NAME clevr_change, ``train.py:
81-105, 217-232``) the batches are (original, changed) pairs drawn by
the pair sampler in the YAML's SAMPLER.MODE with its seeds;
ChangeAwarePrep feeds them to the model as they are, so the test pass
logs a loss and no MACE. Every LOGGING.STEP steps the step's metrics go
to ``<LOGGING.DIR>/metrics.jsonl``; at each epoch's end the test loss
and MACE over TEST_SAMPLES_PER_EPOCH (capped likewise) are logged and a
checkpoint ``<LOGGING.DIR>/model_<step>.pth``
(``training/checkpoint.py``) is written, after the test pass so that it
holds the random state the next epoch starts from.

A run resumes from the newest checkpoint in LOGGING.DIR at epoch
``step // steps_per_epoch`` (``train.py:150-161``) and goes on exactly as
the uninterrupted run would have (the pair and DSAC generators, the
samplers and the host-prep crops restored); SOLVER.RESTART_LEARNING_RATE
starts the optimizer afresh. Without a checkpoint, MODEL.PRETRAINED
warm-starts the model from a port checkpoint where keys and shapes
match. The weights start from a fixed seed; a torchvision ``.pth`` named
by MODEL.BACKBONE.PRETRAINED_RESNET_PATH (with PRETRAINED_RESNET) goes
into the backbone's encoder, and MODEL.HEAD.AUXILIARY_RESNET_PATH (an
``aux_*.npz`` or a torchvision ``.pth``) into the PerceptualHead's
frozen extractor (``train.py:322-384``). Runs on ``cuda`` unless
``--device cpu`` is given, and raises without a card; TF32 is off.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from bihome_torch import config as config_lib
from bihome_torch.data import clevr_change, datasets
from bihome_torch.device import resolve_device
from bihome_torch.models import backbones, torchvision_port, weights
from bihome_torch.training import checkpoint, trainer
from bihome_torch.training.metrics import MetricsWriter
from bihome_torch.training.train_state import Optimizer
from bihome_torch.utils import aux_store

INIT_SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--synthetic', action='store_true',
                        help='the synthetic pool, kept on the device')
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
    """Seeded init of the backbone and the extractor (if the head has one),
    then the torchvision and ``.npz`` weights the config names
    (:func:`load_pretrained_resnets`). Returns the messages to print."""
    model = built.model
    gen = torch.Generator().manual_seed(INIT_SEED)
    backbones.init_weights(model.backbone, gen)
    if model.auxiliary_resnet is not None:
        backbones.init_weights(model.auxiliary_resnet, gen)
    return load_pretrained_resnets(built)


def load_pretrained_resnets(built: config_lib.BuiltModel) -> List[str]:
    """The local-file half of ``maybe_load_pretrained_resnets``
    (``train.py:322-384``): with MODEL.BACKBONE.PRETRAINED_RESNET, a
    torchvision ``.pth`` at PRETRAINED_RESNET_PATH goes into the Rethinking
    encoder (torchvision ``layer1-3`` -> ``layer2-4``) or the ResNet34 /
    ContentAware regressor (its 3-channel stem dropped for the 2-channel
    input, no ``fc``); MODEL.HEAD.AUXILIARY_RESNET_PATH goes into the
    extractor, an ``aux_*.npz`` pruned to its depth or a torchvision
    ``.pth`` (the stem summed over RGB when the extractor's stem has one
    channel). Paths that do not exist leave the seeded init. Returns the
    messages to print."""
    model = built.model
    backbone_cfg = built.config['MODEL']['BACKBONE']
    messages = []
    path = backbone_cfg.get('PRETRAINED_RESNET_PATH')
    if backbone_cfg.get('PRETRAINED_RESNET') and path and os.path.exists(path):
        state = torchvision_port.load_torch_state_dict(path)
        if backbone_cfg['NAME'] == 'Rethinking':
            torchvision_port.graft(
                model.backbone,
                torchvision_port.port_rethinking_encoder(state))
        else:
            torchvision_port.graft(
                model.backbone.resnet34,
                torchvision_port.port_torchvision_resnet(
                    state, num_input_channels=2, include_fc=False))
        messages.append(f'Backbone ImageNet weights loaded from {path}')
    if model.auxiliary_resnet is None:
        return messages
    path = built.config['MODEL']['HEAD'].get('AUXILIARY_RESNET_PATH')
    if not (path and os.path.exists(path)):
        return messages + ['Auxiliary resnet: seeded init (no file given)']
    if path.endswith('.npz'):
        state, dropped = aux_store.state_dict_from_aux(
            aux_store.load_aux_npz(path),
            built.head_cfg.auxiliary_resnet_output_layer)
        weights.load_state_dict(model.auxiliary_resnet, state)
        msg = f'Auxiliary resnet (npz) loaded from {path}'
        if dropped:
            msg += f' (pruned beyond model depth: {", ".join(dropped)})'
        return messages + [msg]
    stem_channels = model.auxiliary_resnet.conv1.weight.shape[1]
    torchvision_port.graft(
        model.auxiliary_resnet, torchvision_port.port_torchvision_resnet(
            torchvision_port.load_torch_state_dict(path), include_fc=False,
            sum_rgb_stem=stem_channels == 1))
    return messages + [f'Auxiliary resnet weights loaded from {path}']


def is_clevr(config: Dict[str, Any]) -> bool:
    """Whether the config trains on CLEVR-Change pairs (``train.py:81``)."""
    return 'clevr_change' in str(config['DATA'].get('NAME', ''))


def make_pools(config: Dict[str, Any], image_size, train_samples: int,
               test_samples: int):
    """The host-side train and test pools (uint8) of ``--synthetic``:
    synthetic images [N,H,W,3] (seeds 0 and 1), or for CLEVR-Change
    [N,2,H,W,3] pairs of :class:`clevr_change.SyntheticChangeDataset`
    (seeds 0 and 1), one per base scene, in the order the pair sampler
    draws them for an epoch of ``train_samples`` / ``test_samples``
    (``train.py:217-232``)."""
    if not is_clevr(config):
        return tuple(datasets.SyntheticDataset(image_size=image_size,
                                               seed=seed).pool
                     for seed in (0, 1))
    sampler_cfg = config['DATA']['SAMPLER']
    mode = sampler_cfg.get('MODE', 'nsc')
    pools = []
    for seed, samples, key in ((0, train_samples, 'TRAIN_SEED'),
                               (1, test_samples, 'TEST_SEED')):
        ds = clevr_change.SyntheticChangeDataset(image_size=image_size,
                                                 seed=seed)
        loader = clevr_change.ClevrPairLoader(
            ds, 1, max(samples, 1), mode=mode,
            random_seed=sampler_cfg.get(key))
        pools.append(loader.pool(len(ds)))
    return tuple(pools)


class PoolFeed:
    """Batches gathered on the device from a pool that lives there, in the
    epoch sampler's order (``--synthetic``)."""

    def __init__(self, pool: torch.Tensor, batch_size: int,
                 samples_per_epoch: int, random_seed: Optional[int]):
        self.pool = pool
        self.batch_size = batch_size
        self.sampler = datasets.EpochSampler(len(pool), samples_per_epoch,
                                             random_seed=random_seed)

    def epoch(self) -> Iterator[torch.Tensor]:
        order = torch.from_numpy(self.sampler.epoch_indices().reshape(
            -1, self.batch_size)).to(self.pool.device)
        for row in order:
            yield self.pool[row]

    def random_sources(self) -> Dict[str, Any]:
        return {'sampler': self.sampler.random_state}


class StreamFeed:
    """Batches of a host loader (``BatchLoader``, ``PackBatchLoader`` or
    the CLEVR pair loader), each copied to ``device`` as it comes: on a
    card through pinned memory, ``non_blocking``."""

    def __init__(self, loader, device: torch.device):
        self.loader = loader
        self.device = device

    def epoch(self) -> Iterator[torch.Tensor]:
        for batch in self.loader.epoch():
            images = torch.from_numpy(batch)
            if self.device.type == 'cuda':
                images = images.pin_memory().to(self.device,
                                                non_blocking=True)
            yield images

    def random_sources(self) -> Dict[str, Any]:
        sources = {'sampler': self.loader.sampler.random_state}
        if isinstance(self.loader.dataset, datasets.HostPrepDataset):
            sources['host_prep'] = self.loader.dataset.random_state
        return sources


def make_feeds(config: Dict[str, Any], built: config_lib.BuiltModel,
               args: argparse.Namespace, device: torch.device,
               batch_size: int, steps: int, test_steps: int,
               train_seed: int, test_seed: int):
    """The train and test feeds (the test feed None when there are no test
    steps or no TEST_SPLIT), as ``train.py:66-133`` builds its loaders;
    ``train_seed`` and ``test_seed`` seed the epoch samplers and the
    host-prep crops."""
    data_cfg = config['DATA']
    sampler_cfg = data_cfg['SAMPLER']
    image_size = tuple(args.image_size)
    if args.synthetic:
        train_np, test_np = make_pools(config, image_size, steps * batch_size,
                                       test_steps * batch_size)
        print(f'Train split: synthetic pool on the device ({len(train_np)})')
        return (PoolFeed(torch.from_numpy(train_np).to(device), batch_size,
                         steps * batch_size, train_seed),
                PoolFeed(torch.from_numpy(test_np).to(device), batch_size,
                         test_steps * batch_size, test_seed)
                if test_steps > 0 else None)
    has_test = 'TEST_SPLIT' in data_cfg and test_steps > 0
    if is_clevr(config):
        mode = sampler_cfg.get('MODE', 'nsc')
        loaders = [clevr_change.ClevrPairLoader(
            clevr_change.ClevrChangeDataset(data_cfg.get(key, ''),
                                            image_size),
            batch_size, n * batch_size, mode=mode, random_seed=seed)
            for key, n, seed in (('TRAIN_SPLIT', steps, train_seed),
                                 ('TEST_SPLIT', test_steps, test_seed))
            if key == 'TRAIN_SPLIT' or has_test]
    else:
        from bihome_torch.data.pack import PackBatchLoader, PackDataset
        loaders = []
        for key, n, seed, spec, synthetic_seed in (
                ('TRAIN_SPLIT', steps, train_seed, built.pair_spec, 0),
                ('TEST_SPLIT', test_steps, test_seed, built.test_pair_spec,
                 1)):
            if key == 'TEST_SPLIT' and not has_test:
                continue
            ds = datasets.make_dataset(
                data_cfg.get(key, ''), image_size=image_size,
                synthetic_seed=synthetic_seed,
                dataset_name=data_cfg.get('NAME', 'coco'))
            if spec.host_prep:
                ds = datasets.HostPrepDataset(ds, spec.host_prep,
                                              random_seed=seed)
                if key == 'TRAIN_SPLIT':
                    ds.load_image(0)    # JAX's init sample draws once
            cls = (PackBatchLoader if isinstance(ds, PackDataset)
                   else datasets.BatchLoader)
            loaders.append(cls(ds, batch_size, n * batch_size,
                               random_seed=seed))
    for key, loader in zip(('Train', 'Test'), loaders):
        print(f'{key} split: {datasets.describe(loader.dataset)} '
              f'({len(loader.dataset)}) from '
              f'{data_cfg.get(key.upper() + "_SPLIT", "")}')
    feeds = [StreamFeed(loader, device) for loader in loaders]
    return feeds[0], (feeds[1] if len(feeds) > 1 else None)


def timed(batches: Iterable, waits: List[float]) -> Iterator:
    """``batches``, appending to ``waits`` the ms each one kept the caller
    waiting."""
    it = iter(batches)
    while True:
        start = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        waits.append((time.perf_counter() - start) * 1e3)
        yield item


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the training; returns what it measured plus the model (for
    callers that check it further): per-step host ms (each step ended by a
    device synchronisation) and the ms each step waited for its batch,
    per-step losses, the state dict at the first step (on the CPU), the
    step the run started from, the checkpoint path, the logged records,
    the parsed arguments and the train feed."""
    args = parse_args(argv)
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
    train_feed, test_feed = make_feeds(config, built, args, device,
                                       batch_size, steps_per_epoch,
                                       test_steps, train_seed, test_seed)
    for line in init_model(built):
        print(line)
    model = built.model.to(device)
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = Optimizer(trainable, **config_lib.solver_kwargs(config))
    print(f'Number of params: {sum(p.numel() for p in trainable)} trainable, '
          f'{sum(p.numel() for p in model.parameters())} in all')

    log_dir = log_cfg['DIR']
    checkpointer = checkpoint.CheckPointer(log_dir)
    restart_lr = bool(config['SOLVER'].get('RESTART_LEARNING_RATE', False))
    saved, start_step = checkpointer.load(model, optimizer,
                                          restart_learning_rate=restart_lr)
    datagen_gen = torch.Generator().manual_seed(train_seed)
    dsac_gen = torch.Generator().manual_seed(train_seed + 1)
    sources = {'datagen': datagen_gen, 'dsac': dsac_gen}
    sources.update({f'train_{k}': v
                    for k, v in train_feed.random_sources().items()})
    if test_feed is not None:
        sources.update({f'test_{k}': v
                        for k, v in test_feed.random_sources().items()})
    if start_step:
        fresh = checkpoint.load_random_state(sources,
                                             saved.get('random', {}))
        print(f'Resumed from {checkpointer.path(start_step)}: step '
              f'{start_step}, optimizer count {optimizer.count}'
              + (f'; from their seeds: {", ".join(fresh)}' if fresh else ''))
    elif 'PRETRAINED' in config['MODEL']:
        checkpoint.load_pretrained_params(config['MODEL']['PRETRAINED'],
                                          model)
        print('Pretrained model loaded!')
    initial_state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
    start_epoch = start_step // steps_per_epoch

    writer = MetricsWriter(log_dir)
    step = start_step
    step_ms: List[float] = []
    wait_ms: List[float] = []
    losses: List[torch.Tensor] = []
    records: List[Dict[str, float]] = []
    ckpt_path = None
    for epoch in range(start_epoch, epochs):
        print(f'Training epoch: {epoch}')
        t_epoch = time.time()
        for images in timed(train_feed.epoch(), wait_ms):
            start = time.perf_counter()
            metrics = trainer.train_step(
                model, optimizer, images, built.pair_spec,
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
        print(f'Epoch {epoch} done in {time.time() - t_epoch:.1f}s')

        if test_feed is not None:
            print(f'Testing epoch: {epoch}')
            gen = torch.Generator().manual_seed(test_seed)
            dgen = torch.Generator().manual_seed(test_seed + 1)
            sums: Dict[str, torch.Tensor] = {}
            for images in test_feed.epoch():
                m = trainer.eval_step(model, images, built.test_pair_spec,
                                      built.loss_name, gen, dgen)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + v
            rec = writer.scalars((epoch + 1) * steps_per_epoch,
                                 {k: v / test_steps for k, v in sums.items()})
            records.append(rec)
            print(f'Test loss: {rec["loss/test"]}  '
                  f'test mace: {rec.get("mace/test")}')
        ckpt_path = checkpointer.save(step, model, optimizer, sources)
    writer.close()
    print('DONE!')
    timed_ms = step_ms[1:] if len(step_ms) > 1 else step_ms
    timed_wait = wait_ms[1:] if len(wait_ms) > 1 else wait_ms
    return {'model': model, 'optimizer': optimizer, 'step': step,
            'start_step': start_step, 'step_ms': step_ms,
            'median_step_ms': float(np.median(timed_ms)) if step_ms else 0.0,
            'wait_ms': wait_ms,
            'median_wait_ms': (float(np.median(timed_wait)) if wait_ms
                               else 0.0),
            'losses': torch.stack(losses).cpu() if losses else None,
            'initial_state': initial_state, 'checkpoint': ckpt_path,
            'records': records, 'batch_size': batch_size,
            'log_dir': log_dir, 'built': built, 'args': args,
            'train_feed': train_feed}


if __name__ == '__main__':
    main()
