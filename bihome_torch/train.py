"""Train entry point of the port (counterpart of ``train.py:44-384``).

    python -m bihome_torch.train --config_file X.yaml [--synthetic]
        [--steps N] [--batch_size B] [--epochs E] [--set K=V]
        [--image_size W H] [--device cuda|cpu]
        [--dtype float32|bfloat16] [--lr LR]
        [--feed pool|stream] [--pool_size 1024]
        [--pool_refresh_steps 1000] [--pool_shard]
        [--steps_per_call K] [--profile]
        [--multihost [--coordinator HOST:PORT --num_processes N
                      --process_id R]]

Reads the same reference-schema YAML. The images come from the config's
DATA.TRAIN_SPLIT / TEST_SPLIT (``datasets.make_dataset``: an image or
``.npy`` folder, a ``.bhpk`` pack, a CIFAR-10 pickle directory; the
synthetic images when the path does not exist; for CLEVR-Change,
``clevr_change.ClevrChangeDataset``), with the config's host-side prep
transforms. ``--synthetic`` selects the synthetic images (256 of them;
CLEVR-Change: ``SyntheticChangeDataset``) whatever the splits name.

Two feeds, as in JAX (``train.py:166-311``):

* ``--feed pool`` (the default): a device-resident pool of
  ``min(--pool_size, len(dataset))`` images, drawn by the epoch sampler
  seeded by TRAIN_SEED (CLEVR-Change: the pair loader's pool of pairs);
  each step draws its batch from it on the device, with replacement, from
  a generator there (``trainer.pool_train_block``). When the dataset holds
  more images than the pool, one background thread builds the next pool
  (``datasets.PoolRefresher``), and the pool is swapped every
  ``max(1, --pool_refresh_steps // K)`` blocks. The test pass averages
  TEST_SAMPLES_PER_EPOCH / B batches drawn the same way from a test pool
  built once from TEST_SEED (``trainer.pool_eval``).
* ``--feed stream``: each batch is decoded by the loader's producer
  thread (the native prefetch ring for a pack) and copied to the card
  through pinned memory; each epoch takes TRAIN_SAMPLES_PER_EPOCH images
  (capped by ``--steps`` x batch) in the epoch sampler's order.

Either way the loop runs blocks of K = ``--steps_per_call`` steps (0: the
largest divisor of the epoch and LOGGING.STEP up to 25,
``trainer.pick_steps_per_call``; a last, shorter block runs what K leaves
of an epoch) and waits for the device once per block.

``--multihost`` trains data-parallel over ranks, one process each
(``parallel.mesh.init_from_args``: ``--coordinator HOST:PORT
--num_processes N --process_id R``, or torchrun's environment), as JAX's
mesh step does (``train.py:163-185, 432-449``): B is the global batch,
each rank steps on its B/R slice with the global batch's draws, batch
statistics and summed gradients (``training/trainer.py``), and the
logged metrics are the global batch's. Rank 0 alone writes
``metrics.jsonl`` and the checkpoints; ``throughput/pairs_per_sec_per_chip``
divides by the ranks. Every rank holds the whole device pool and draws
the global batch's indices, or with ``--pool_shard`` (``train.py:
176-181, 210-212``) rows ``[r P/R, (r+1) P/R)`` of a pool of P rounded
down to a multiple of R, and its B/R indices from its own generator
(seeded by the draw seed and r, JAX's ``fold_in(key, axis_index)``);
the checkpoint then holds every rank's draw generator (``train_draws@r``),
so a resumed run goes on as the run without a stop. On one rank
``--pool_shard`` changes nothing. The test pass runs whole on every rank
(JAX's replicated eval block).
``--profile`` writes a ``torch.profiler`` chrome trace of the third block
into ``<LOGGING.DIR>/profile``.

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
logs a loss and no MACE. At each step that is a multiple of LOGGING.STEP
the block's last metrics, with ``throughput/pairs_per_sec_per_chip``
over the window since the last such step, go to
``<LOGGING.DIR>/metrics.jsonl``; at each epoch's end the test loss and
MACE are logged and a checkpoint ``<LOGGING.DIR>/model_<step>.pth``
(``training/checkpoint.py``) is written, after the test pass so that it
holds the random state the next epoch starts from.

A run resumes from the newest checkpoint in LOGGING.DIR at epoch
``step // steps_per_epoch`` (``train.py:150-161``) and goes on exactly as
the uninterrupted run would have (the pair, DSAC and pool-draw
generators, the samplers and the host-prep crops restored). Through the
pool this holds because the pool in use is a function of the step: pool
number ``step // K // refresh_blocks``, rebuilt from the random state at
its start, which the checkpoint holds; at a swap the loop waits for the
refresher (JAX swaps only if the next pool happens to be ready). A
generator state written on another device type starts that generator
from its seed, named in the "from their seeds" line.
SOLVER.RESTART_LEARNING_RATE starts the optimizer afresh. Without a
checkpoint, MODEL.PRETRAINED warm-starts the model from a port checkpoint
where keys and shapes match. ``--dtype`` overrides MODEL.DTYPE and
``--lr`` SOLVER.LR (``train.py:47-50,399-400``): at bfloat16 the
activations are bf16 (the kernels' bf16 forms on the card) and the
parameters, optimizer state and checkpoints float32, so a checkpoint
written at one dtype loads at the other. The weights start from a fixed
seed; a torchvision ``.pth`` named by MODEL.BACKBONE.PRETRAINED_RESNET_PATH
(with PRETRAINED_RESNET) goes into the backbone's encoder, and
MODEL.HEAD.AUXILIARY_RESNET_PATH (an ``aux_*.npz`` or a torchvision
``.pth``) into the PerceptualHead's frozen extractor, and with
MODEL.HEAD.SCORE_CNN_PRETRAINED a torchvision resnet18 ``.pth`` at
SCORE_CNN_PATH into the DSAC score CNN (``train.py:322-384``). Runs on ``cuda`` unless ``--device cpu`` is given, and raises
without a card; TF32 is off.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from bihome_torch import config as config_lib
from bihome_torch.data import clevr_change, datasets, pipeline
from bihome_torch.models import backbones, torchvision_port, weights
from bihome_torch.parallel import dist_util, mesh
from bihome_torch.training import checkpoint, trainer
from bihome_torch.training.metrics import MetricsWriter, NullWriter
from bihome_torch.training.train_state import Optimizer
from bihome_torch.utils import aux_store

INIT_SEED = 0
# The pool draws' generators are seeded apart from the pair (seed) and
# DSAC (seed + 1) generators of the same split.
DRAW_SEED_OFFSET = 2
# ``--profile`` traces this block (0-based), as JAX starts its trace
# before its third dispatch (``train.py:277-284``).
PROFILED_BLOCK = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--synthetic', action='store_true',
                        help='the synthetic images, whatever the splits name')
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
    parser.add_argument('--dtype', choices=('float32', 'bfloat16'),
                        default='', help='override MODEL.DTYPE')
    parser.add_argument('--lr', type=float, default=0.0,
                        help='override SOLVER.LR')
    parser.add_argument('--feed', choices=('pool', 'stream'), default='pool',
                        help="'pool' keeps a device-resident image pool, "
                             "refreshed in the background (default); "
                             "'stream' copies each batch from the host "
                             'loader')
    parser.add_argument('--pool_size', type=int, default=1024,
                        help='device image-pool size (feed=pool)')
    parser.add_argument('--pool_refresh_steps', type=int, default=1000,
                        help='refresh the device pool every N steps')
    parser.add_argument('--pool_shard', action='store_true',
                        help='shard the pool over the ranks; each rank '
                             'draws from its own shard (no effect on one)')
    parser.add_argument('--steps_per_call', type=int, default=0,
                        help='train steps per block, one device wait each '
                             '(default: auto divisor of LOGGING.STEP)')
    parser.add_argument('--profile', action='store_true',
                        help='write a torch.profiler trace of the third '
                             'block into LOGGING.DIR/profile')
    mesh.add_arguments(parser)
    return parser.parse_args(argv)


def init_model(built: config_lib.BuiltModel) -> List[str]:
    """Seeded init of the backbone, the extractor, the projection head and
    the score CNN (where the head has them), then the torchvision and
    ``.npz`` weights the config names (:func:`load_pretrained_resnets`).
    Returns the messages to print."""
    model = built.model
    gen = torch.Generator().manual_seed(INIT_SEED)
    backbones.init_weights(model.backbone, gen)
    for part in (model.auxiliary_resnet, model.projection_head,
                 model.score_cnn):
        if part is not None:
            backbones.init_weights(part, gen)
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
    channel); with MODEL.HEAD.SCORE_CNN_PRETRAINED, a torchvision resnet18
    ``.pth`` at SCORE_CNN_PATH goes into the DSAC score CNN but for its
    stem (2 input channels) and its fc (1 unit), which keep the seeded
    init (``train.py:370-383``). Paths that do not exist leave the seeded
    init. Returns the messages to print."""
    model = built.model
    backbone_cfg = built.config['MODEL']['BACKBONE']
    head_cfg = built.config['MODEL']['HEAD']
    messages = []
    path = head_cfg.get('SCORE_CNN_PATH')
    if (head_cfg.get('SCORE_CNN_PRETRAINED') and model.score_cnn is not None
            and path and os.path.exists(path)):
        torchvision_port.graft(
            model.score_cnn, torchvision_port.port_torchvision_resnet(
                torchvision_port.load_torch_state_dict(path),
                num_input_channels=2, include_fc=False))
        messages.append(f'Score CNN ImageNet weights loaded from {path}')
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
    path = head_cfg.get('AUXILIARY_RESNET_PATH')
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


def upload(pool: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host pool on ``device``: to a card through pinned memory,
    ``non_blocking`` (ordered on the current stream, no host wait)."""
    tensor = torch.from_numpy(pool)
    if device.type == 'cuda':
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor


class PoolFeed:
    """The device pool of ``--feed pool`` (``train.py:208-252, 286-292``).
    Pool k of ``source`` serves the blocks ``k * refresh_blocks`` to
    ``(k + 1) * refresh_blocks - 1``, that is the steps ``step`` with
    ``step // (steps_per_call * refresh_blocks) == k``; with ``refresh``
    off (the dataset fits in one pool) pool 0 serves every step. Batches
    are drawn on the pool's device from ``draws``. With ``rows`` (a slice)
    only those rows of each pool go to the device: this rank's shard.

    :meth:`random_sources` are the states a checkpoint holds: the draw
    generator and the pool sources as they were when the pool in use
    began. :meth:`start` builds the pool of a run's first step from them
    (and starts the refresher); :meth:`advance` swaps at a pool boundary,
    waiting for the refresher (at most ``swap_timeout`` seconds when it
    is set), and returns the ms it waited."""

    swap_timeout: Optional[float] = None

    def __init__(self, source: datasets.PoolSource, dataset,
                 device: torch.device, steps_per_call: int,
                 refresh_blocks: int, refresh: bool, draw_seed: int,
                 rows: Optional[slice] = None):
        self.source = source
        self.rows = rows
        self.dataset = dataset
        self.device = device
        self.steps_per_pool = steps_per_call * refresh_blocks
        self.refresh = refresh
        self.draws = torch.Generator(device=device).manual_seed(draw_seed)
        self.index = 0
        self.pool: Optional[torch.Tensor] = None
        self.refresher: Optional[datasets.PoolRefresher] = None
        self.first_pool_s = 0.0
        self.swaps: Dict[int, float] = {}
        self._start_states = source.start_states(0)

    def pool_of(self, step: int) -> int:
        return step // self.steps_per_pool if self.refresh else 0

    def random_sources(self) -> Dict[str, Any]:
        if self.pool is not None:
            self._start_states = self.source.start_states(self.index)
        sources = {'draws': self.draws}
        sources.update({f'pool_{k}': v
                        for k, v in self._start_states.items()})
        return sources

    def start(self, step: int) -> None:
        self.source.restore(self._start_states)
        self.index = self.pool_of(step)
        begin = time.perf_counter()
        self.pool = self.upload(self.source.build(self.index))
        self.first_pool_s = time.perf_counter() - begin
        if self.refresh:
            self.refresher = datasets.PoolRefresher(self.source,
                                                    self.index + 1)

    def advance(self, step: int) -> float:
        """Swap in the pool of ``step`` if it is the next one; the ms it
        took (0.0 without a swap)."""
        if self.pool_of(step) == self.index:
            return 0.0
        begin = time.perf_counter()
        self.pool = self.upload(self.refresher.get(self.swap_timeout))
        self.index += 1
        wait = (time.perf_counter() - begin) * 1e3
        self.swaps[step] = wait
        return wait

    def upload(self, pool: np.ndarray) -> torch.Tensor:
        return upload(pool if self.rows is None else pool[self.rows],
                      self.device)

    def close(self) -> None:
        if self.refresher is not None:
            self.refresher.close()


class StreamFeed:
    """Batches of a host loader (``BatchLoader``, ``PackBatchLoader`` or
    the CLEVR pair loader), each copied to ``device`` as it comes: on a
    card through pinned memory, ``non_blocking``. With ``rows`` (a slice)
    only those rows of each batch: this rank's slice."""

    def __init__(self, loader, device: torch.device,
                 rows: Optional[slice] = None):
        self.loader = loader
        self.device = device
        self.rows = rows

    def epoch(self) -> Iterator[torch.Tensor]:
        for batch in self.loader.epoch():
            yield upload(batch if self.rows is None else batch[self.rows],
                         self.device)

    def random_sources(self) -> Dict[str, Any]:
        sources = {'sampler': self.loader.sampler.random_state}
        if isinstance(self.loader.dataset, datasets.HostPrepDataset):
            sources['host_prep'] = self.loader.dataset.random_state
        return sources


def make_loaders(config: Dict[str, Any], built: config_lib.BuiltModel,
                 args: argparse.Namespace, batch_size: int, steps: int,
                 test_steps: int, train_seed: int, test_seed: int):
    """The train and test loaders (the test loader None when there are no
    test steps or no TEST_SPLIT), as ``train.py:66-133`` builds them;
    ``train_seed`` and ``test_seed`` seed the epoch samplers and the
    host-prep crops. ``--synthetic`` takes the synthetic images (seeds 0
    and 1) whatever the splits name."""
    data_cfg = config['DATA']
    sampler_cfg = data_cfg['SAMPLER']
    image_size = tuple(args.image_size)
    has_test = 'TEST_SPLIT' in data_cfg and test_steps > 0
    splits = [('TRAIN_SPLIT', steps, train_seed, built.pair_spec, 0)]
    if has_test:
        splits.append(('TEST_SPLIT', test_steps, test_seed,
                       built.test_pair_spec, 1))
    loaders = []
    for key, n, seed, spec, synthetic_seed in splits:
        if is_clevr(config):
            ds = (clevr_change.SyntheticChangeDataset(image_size=image_size,
                                                      seed=synthetic_seed)
                  if args.synthetic else
                  clevr_change.ClevrChangeDataset(data_cfg.get(key, ''),
                                                  image_size))
            loaders.append(clevr_change.ClevrPairLoader(
                ds, batch_size, n * batch_size,
                mode=sampler_cfg.get('MODE', 'nsc'), random_seed=seed))
            continue
        from bihome_torch.data.pack import PackBatchLoader, PackDataset
        ds = (datasets.SyntheticDataset(image_size=image_size,
                                        seed=synthetic_seed)
              if args.synthetic else datasets.make_dataset(
                  data_cfg.get(key, ''), image_size=image_size,
                  synthetic_seed=synthetic_seed,
                  dataset_name=data_cfg.get('NAME', 'coco')))
        if spec.host_prep:
            ds = datasets.HostPrepDataset(ds, spec.host_prep,
                                          random_seed=seed)
            if key == 'TRAIN_SPLIT':
                ds.load_image(0)    # JAX's init sample draws once
        cls = (PackBatchLoader if isinstance(ds, PackDataset)
               else datasets.BatchLoader)
        loaders.append(cls(ds, batch_size, n * batch_size, random_seed=seed))
    for (key, *_), loader in zip(splits, loaders):
        origin = '--synthetic' if args.synthetic else data_cfg.get(key, '')
        print(f'{key.split("_")[0].capitalize()} split: '
              f'{datasets.describe(loader.dataset)} '
              f'({len(loader.dataset)}) from {origin}')
    return loaders[0], (loaders[1] if len(loaders) > 1 else None)


def pool_source(loader, pool_size: int, seed: int) -> datasets.PoolSource:
    """The pools of a loader's dataset: ``min(pool_size, len(dataset))``
    images at an epoch sampler's indices seeded by ``seed``, or for
    CLEVR-Change as many pairs of the pair loader (``train.py:210-223,
    228-239``)."""
    n = min(pool_size, len(loader.dataset))
    if isinstance(loader, clevr_change.ClevrPairLoader):
        return datasets.PoolSource(
            lambda: loader.pool(n),
            {'sampler': loader.sampler.random_state})
    return datasets.image_pool_source(loader.dataset, pool_size, seed)


def make_feeds(config: Dict[str, Any], built: config_lib.BuiltModel,
               args: argparse.Namespace, device: torch.device,
               batch_size: int, steps: int, test_steps: int,
               train_seed: int, test_seed: int, steps_per_call: int = 1):
    """The train feed and the test feed of ``args.feed`` (a
    :class:`PoolFeed` and the test pool on ``device``, or two
    :class:`StreamFeed`), the test feed None without test steps or
    TEST_SPLIT. The pool feed is not started: :meth:`PoolFeed.start`.
    Across ranks the train feed gives this rank's slice of each batch, or
    with ``--pool_shard`` holds this rank's shard of each pool; the test
    feed is whole on every rank."""
    train_loader, test_loader = make_loaders(
        config, built, args, batch_size, steps, test_steps, train_seed,
        test_seed)
    world, rank = dist_util.get_world_size(), dist_util.get_rank()
    if args.feed == 'stream':
        lo, hi = mesh.shard_range(batch_size, world, rank)
        return (StreamFeed(train_loader, device,
                           slice(lo, hi) if world > 1 else None),
                StreamFeed(test_loader, device) if test_loader else None)
    pool_size, rows = args.pool_size, None
    draw_seed = train_seed + DRAW_SEED_OFFSET
    if args.pool_shard and world > 1:
        pool_size = min(pool_size, len(train_loader.dataset))
        pool_size -= pool_size % world
        rows = slice(*mesh.shard_range(pool_size, world, rank))
        draw_seed = pipeline.sample_seed(draw_seed, rank)
    refresh = len(train_loader.dataset) > pool_size
    feed = PoolFeed(pool_source(train_loader, pool_size, train_seed),
                    train_loader.dataset, device, steps_per_call,
                    max(1, args.pool_refresh_steps // steps_per_call),
                    refresh, draw_seed, rows)
    test_pool = None
    if test_loader is not None:
        test_pool = upload(pool_source(test_loader, args.pool_size,
                                       test_seed).build(0), device)
    return feed, test_pool


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


def blocks_of(steps: int, spc: int) -> List[int]:
    """The block lengths of an epoch of ``steps`` steps: ``spc`` each, the
    last one what remains."""
    return [spc] * (steps // spc) + ([steps % spc] if steps % spc else [])


def profiled_share(prof, wall_ms: float) -> Dict[str, float]:
    """Device kernel ms and launches of a profiled window of ``wall_ms``
    host ms, and the device's idle share of it."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {'wall_ms': wall_ms, 'device_ms': device_ms,
            'launches': sum(e.count for e in kernels),
            'idle_share': 1 - device_ms / wall_ms}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the training; returns what it measured plus the model (for
    callers that check it further): per-step host ms (each block's time,
    ended by a device synchronisation, over its steps) and the ms each
    step waited for its input (stream: its batch; pool: a swap before its
    block, spread over the block's steps, and the swaps by step in
    ``swap_ms``), per-step losses, the state dict at the first step (on
    the CPU), the step the run started from, the checkpoint path, the
    logged records, the parsed arguments, the train feed, the steps per
    block, the first pool's seconds and the profiled block's figures."""
    args = parse_args(argv)
    device = mesh.init_from_args(args)
    try:
        return _train(args, device)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, device: torch.device) -> Dict[str, Any]:
    world, rank = dist_util.get_world_size(), dist_util.get_rank()
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = config_lib.load_config(args.config_file)
    config_lib.apply_overrides(config, args.set)
    if args.lr:
        config['SOLVER']['LR'] = args.lr
    if args.dtype:
        config['MODEL']['DTYPE'] = args.dtype
    sampler_cfg = config['DATA']['SAMPLER']
    log_cfg = config['LOGGING']
    batch_size = args.batch_size or sampler_cfg['BATCH_SIZE']
    mesh.shard_range(batch_size, world, rank)       # B % R == 0
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
    spc = args.steps_per_call or trainer.pick_steps_per_call(
        steps_per_epoch, log_step)
    print(f'steps_per_call: {spc}')

    built = config_lib.build_model(config)
    train_feed, test_feed = make_feeds(config, built, args, device,
                                       batch_size, steps_per_epoch,
                                       test_steps, train_seed, test_seed,
                                       spc)
    pooled = args.feed == 'pool'
    # Under --pool_shard the ranks' draw generators differ: the checkpoint
    # holds each one.
    rank_draws = pooled and args.pool_shard and world > 1
    for line in init_model(built):
        print(line)
    model = built.model.to(device)
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = Optimizer(trainable, **config_lib.solver_kwargs(config))
    print(f'Number of params: {sum(p.numel() for p in trainable)} trainable, '
          f'{sum(p.numel() for p in model.parameters())} in all; compute '
          f'dtype {str(built.dtype).replace("torch.", "")}')

    log_dir = log_cfg['DIR']
    checkpointer = checkpoint.CheckPointer(log_dir)
    restart_lr = bool(config['SOLVER'].get('RESTART_LEARNING_RATE', False))
    saved, start_step = checkpointer.load(model, optimizer,
                                          restart_learning_rate=restart_lr)
    datagen_gen = torch.Generator().manual_seed(train_seed)
    dsac_gen = torch.Generator().manual_seed(train_seed + 1)

    def random_sources() -> Dict[str, Any]:
        sources = {'datagen': datagen_gen, 'dsac': dsac_gen}
        sources.update({f'train_{k}': v
                        for k, v in train_feed.random_sources().items()})
        if isinstance(test_feed, StreamFeed):
            sources.update({f'test_{k}': v
                            for k, v in test_feed.random_sources().items()})
        return sources

    if start_step:
        saved_random = dict(saved.get('random', {}))
        if rank_draws and f'train_draws@{rank}' in saved_random:
            saved_random['train_draws'] = saved_random[f'train_draws@{rank}']
        fresh = checkpoint.load_random_state(random_sources(), saved_random)
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
    if pooled:
        train_feed.start(start_step)
        print(f'Train pool: {len(train_feed.pool)} images on {device} '
              f'({train_feed.pool.numel() / 1e6:.1f} MB), built in '
              f'{train_feed.first_pool_s:.2f} s; refreshed every '
              f'{train_feed.steps_per_pool} steps: {train_feed.refresh}')

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    def save_checkpoint() -> Optional[str]:
        """Rank 0 writes the checkpoint; every rank gives its draw
        generator's state first where they differ."""
        states = {}
        if rank_draws:
            mine = checkpoint.random_state_dict({'d': train_feed.draws})['d']
            states = {f'train_draws@{r}': state for r, state in
                      enumerate(dist_util.all_gather(mine))}
        if not dist_util.is_main_process():
            return None
        return checkpointer.save(step, model, optimizer, random_sources(),
                                 states)

    writer = MetricsWriter(log_dir) if rank == 0 else NullWriter()
    step = start_step
    step_ms: List[float] = []
    wait_ms: List[float] = []
    losses: List[torch.Tensor] = []
    records: List[Dict[str, float]] = []
    ckpt_path = None
    last_log_time = None
    profile = None
    block_count = 0
    swap_wait = 0.0
    try:
        for epoch in range(start_epoch, epochs):
            print(f'Training epoch: {epoch}')
            t_epoch = time.time()
            batches = (None if pooled else
                       timed(train_feed.epoch(), wait_ms))
            for n in blocks_of(steps_per_epoch, spc):
                if pooled:
                    wait_ms.extend([swap_wait / n] * n)
                else:
                    images = [next(batches) for _ in range(n)]
                prof = None
                if args.profile and block_count == PROFILED_BLOCK:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == 'cuda':
                        activities.append(
                            torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                start = time.perf_counter()
                if pooled:
                    metrics, block_losses = trainer.pool_train_block(
                        model, optimizer, train_feed.pool, n, batch_size,
                        built.pair_spec, built.loss_name, train_feed.draws,
                        datagen_gen, dsac_gen, args.pool_shard)
                else:
                    block_losses = []
                    for batch in images:
                        metrics = trainer.train_step(
                            model, optimizer, batch, built.pair_spec,
                            built.loss_name, datagen_gen, dsac_gen)
                        block_losses.append(metrics['loss/train'])
                sync()
                block_ms = (time.perf_counter() - start) * 1e3
                if prof is not None:
                    prof.stop()
                    trace_dir = os.path.join(log_dir, 'profile')
                    os.makedirs(trace_dir, exist_ok=True)
                    prof.export_chrome_trace(
                        os.path.join(trace_dir, 'trace.json'))
                    profile = {'block': block_count, 'steps': n,
                               'trace': os.path.join(trace_dir,
                                                     'trace.json')}
                    if device.type == 'cuda':
                        profile.update(profiled_share(prof, block_ms))
                        print(f'Profiled block: {block_ms:.2f} ms host, '
                              f'{profile["device_ms"]:.2f} ms device, idle '
                              f'share {profile["idle_share"]:.3f}')
                    print(f'Profile trace written to {log_dir}/profile')
                step_ms.extend([block_ms / n] * n)
                losses.extend(block_losses)
                step += n
                block_count += 1
                if pooled:
                    swap_wait = train_feed.advance(step)
                if step % log_step == 0:
                    metrics = trainer.global_metrics(metrics,
                                                     built.loss_name)
                    now = time.time()
                    if last_log_time is not None:
                        metrics = dict(metrics)
                        metrics['throughput/pairs_per_sec_per_chip'] = (
                            log_step * batch_size / (now - last_log_time)
                            / world)
                    last_log_time = now
                    rec = writer.scalars(step, metrics)
                    if rec:
                        records.append(rec)
                    if verbose and rec:
                        print(f'Epoch: {epoch} step: {step} '
                              f'loss: {rec["loss/train"]:.5f}')
            if batches is not None:
                for _ in batches:   # the loader's end: its thread joined
                    raise RuntimeError('the loader gave more batches than '
                                       'the epoch has steps')
            print(f'Epoch {epoch} done in {time.time() - t_epoch:.1f}s')

            if test_feed is not None:
                print(f'Testing epoch: {epoch}')
                gen = torch.Generator().manual_seed(test_seed)
                dgen = torch.Generator().manual_seed(test_seed + 1)
                if pooled:
                    means = trainer.pool_eval(
                        model, test_feed, test_steps, batch_size,
                        built.test_pair_spec, built.loss_name,
                        torch.Generator(device=device).manual_seed(
                            test_seed + DRAW_SEED_OFFSET), gen, dgen)
                else:
                    sums: Dict[str, torch.Tensor] = {}
                    for images in test_feed.epoch():
                        m = trainer.eval_step(model, images,
                                              built.test_pair_spec,
                                              built.loss_name, gen, dgen)
                        for k, v in m.items():
                            sums[k] = sums.get(k, 0.0) + v
                    means = {k: v / test_steps for k, v in sums.items()}
                rec = writer.scalars((epoch + 1) * steps_per_epoch, means)
                if rec:
                    records.append(rec)
                    print(f'Test loss: {rec["loss/test"]}  '
                          f'test mace: {rec.get("mace/test")}')
            ckpt_path = save_checkpoint()
    finally:
        if pooled:
            train_feed.close()
        writer.close()
    print('DONE!')
    timed_ms = step_ms[spc:] if len(step_ms) > spc else step_ms
    timed_wait = wait_ms[1:] if len(wait_ms) > 1 else wait_ms
    return {'model': model, 'optimizer': optimizer, 'step': step,
            'start_step': start_step, 'step_ms': step_ms,
            'median_step_ms': float(np.median(timed_ms)) if step_ms else 0.0,
            'wait_ms': wait_ms,
            'median_wait_ms': (float(np.median(timed_wait)) if wait_ms
                               else 0.0),
            'swap_ms': train_feed.swaps if pooled else {},
            'losses': torch.stack(losses).cpu() if losses else None,
            'initial_state': initial_state, 'checkpoint': ckpt_path,
            'records': records, 'batch_size': batch_size,
            'log_dir': log_dir, 'built': built, 'args': args,
            'train_feed': train_feed, 'steps_per_call': spc,
            'first_pool_s': train_feed.first_pool_s if pooled else None,
            'profile': profile}


if __name__ == '__main__':
    main()
