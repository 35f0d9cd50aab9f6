"""Where the training step's time goes on the card.

    python -m bihome_torch.profile_train [--config_file X.yaml]
        [--batch_size 64] [--steps 6] [--set K=V]

Builds the model, optimizer and device pool as ``bihome_torch.train
--synthetic`` does (the synthetic images, seeded backbone, a
PerceptualHead's extractor from ``aux_clfbh.npz``), then runs ``--steps``
calls of the real ``training.trainer.train_step`` on batches drawn on the
device (``trainer.draw_pool_batch``) after two warm-up calls, each split into
phases by the program's spans (``bihome_torch.tracing``), recorded with a
CUDA event at each end. For zeng-biHomE (a head with DSAC):

  datagen (pair synthesis, K3) | backbone forward (K1) | DSAC both ways |
  loss forward (warp K3, extractor twice, triplet tail) | loss backward
  down to the corner deltas (triplet tail, extractor input grads, K4) |
  DSAC backward (DLT, down to the perspective fields) | backbone backward
  (K2, cuDNN) | optimizer (gradient norm, Adam) | metrics

For the heads without DSAC (the ResNet34 and zhang families, zeng-orig
and CLEVR-Change zhang, whose pool holds (original, changed) pairs):

  datagen (pair synthesis with the PDS distortion, K3; CLEVR-Change:
  grayscale and standardize) | backbone forward (zeng-orig: K1)
  | head/loss forward (the head: detone-biHomE's warp K3, extractor twice
  and triplet tail; the PhotometricHead's warp of the full image, K3) |
  head/loss backward down to the backbone's deltas (with the tensor
  loss's forward; extractor input grads, K4) | backbone backward (zeng-
  orig: K2) |
  optimizer | metrics

A phase ends at a span's end or at a mark that a gradient hook makes
(:data:`BOUNDS`): ``bwd.deltas`` when the gradient has reached both
directions' corner deltas, ``bwd.backbone`` when it has reached every
output of the backbone. The ``model.extractor`` spans give the frozen
extractor's share of the loss forward (both passes); its input-gradient
backward runs inside autograd, where no span reaches. The host's time
inside the step's spans is the time it takes to launch the step's work
(and to wait where the step waits for the device). The ``copy.h2d``
counts give the host-to-device copies a step, their bytes and the spans
that make them (each a ``.to(device)`` of a host tensor). It then
profiles the same steps with ``torch.profiler``, the spans on (so that
its trace names the program's layers): device busy time and launches per
step, the device idle share of the host-clock window, and the device
time by kind of kernel (each of the port's kernels by name). Needs a
CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from bihome_torch import config as config_lib
from bihome_torch import profile_predict, tracing, train
from bihome_torch.device import resolve_device
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer

CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
# Each phase ends at a boundary of the step's spans: the end (1) or the
# start (0) of the last span or mark of that name. The step starts where
# the pool draw (train.draw) does.
BOUNDS = (('datagen', 'model.backbone', 0),
          ('backbone fwd', 'model.backbone', 1),
          ('dsac fwd', 'model.dsac', 1),
          ('loss fwd', 'train.forward', 1),
          ('loss bwd to the deltas', 'bwd.deltas', 1),
          ('dsac bwd', 'bwd.backbone', 1),
          ('backbone bwd', 'train.backward', 1),
          ('optimizer', 'train.optimizer', 1),
          ('metrics', 'train.metrics', 1))
BOUNDS_NO_DSAC = (('datagen', 'model.backbone', 0),
                  ('backbone fwd', 'model.backbone', 1),
                  ('head/loss fwd', 'train.forward', 1),
                  ('head/loss bwd', 'bwd.backbone', 1),
                  ('backbone bwd', 'train.backward', 1),
                  ('optimizer', 'train.optimizer', 1),
                  ('metrics', 'train.metrics', 1))


def phase_ms(spans, bounds):
    """Each phase's ms on the stream from one step's spans recorded with
    device timing (``tracing.recording(device=True)``)."""
    last = {}
    for s in spans:
        last[s['name']] = s['device_ms']
    ends = [last[name][side] for _, name, side in bounds]
    return {phase: b - a for (phase, _, _), a, b in
            zip(bounds, [last['train.draw'][0]] + ends[:-1], ends)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', default=CONFIG)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--steps', type=int, default=6)
    parser.add_argument('--set', action='append', default=[],
                        metavar='KEY=VALUE', help='dotted config override')
    args = parser.parse_args(argv)
    device = resolve_device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'device {torch.cuda.get_device_name(device)}; config '
          f'{args.config_file} {" ".join(args.set)}, batch {args.batch_size}')
    config = config_lib.load_config(args.config_file)
    config_lib.apply_overrides(
        config, ['MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz', *args.set])
    built = config_lib.build_model(config)
    for line in train.init_model(built):
        print(line)
    model = built.model.to(device).train()
    optimizer = Optimizer([p for p in model.parameters() if p.requires_grad],
                          **config_lib.solver_kwargs(config))
    loader, _ = train.make_loaders(
        config, built, train.parse_args(['--config_file', args.config_file,
                                         '--synthetic']),
        args.batch_size, 1, 0, 0, 0)
    pool = train.upload(train.pool_source(loader, 1024, 0).build(0), device)
    gen = torch.Generator().manual_seed(0)
    dsac_gen = torch.Generator().manual_seed(1)
    draws = torch.Generator(device=device).manual_seed(2)

    dsac = built.needs_dsac_rng
    bounds = BOUNDS if dsac else BOUNDS_NO_DSAC

    def one_step():
        return trainer.train_step(
            model, optimizer,
            trainer.draw_pool_batch(pool, args.batch_size, draws),
            built.pair_spec, built.loss_name, gen, dsac_gen)

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    host, in_spans, recordings = [], [], []
    for _ in range(args.steps):
        start = time.perf_counter()
        with tracing.recording(device=True) as rec:
            one_step()
        host.append((time.perf_counter() - start) * 1e3)
        recordings.append(rec)
        in_spans.append(sum(s['end_ns'] - s['start_ns'] for s in rec.spans
                         if s['parent'] is None) * 1e-6)
        for name, ms in phase_ms(rec.spans, bounds).items():
            events[name].append(ms)
        events['extractor fwd'].append(sum(
            s['device_ms'][1] - s['device_ms'][0] for s in rec.spans
            if s['name'] == 'model.extractor'))
    total = 0.0
    for name, _, _ in bounds:
        ms = statistics.median(events[name])
        total += ms
        print(f'{name}: median {ms:.3f} ms per step (spans, CUDA events)')
    if any(events['extractor fwd']):
        print(f'  extractor fwd: median '
              f'{statistics.median(events["extractor fwd"]):.3f} ms per step '
              f'(within {"loss fwd" if dsac else "head/loss fwd"}, both '
              'passes)')
    print(f'phases sum {total:.3f} ms; host step {statistics.median(host):.3f}'
          f' ms (median of {args.steps}, each ended by a synchronize), of '
          f'which the host is in the step\'s spans '
          f'{statistics.median(in_spans):.3f} ms; '
          f'pairs/s {args.batch_size / (statistics.median(host) / 1e3):.1f}')
    print(profile_predict.copies_line(recordings, 'step'))

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, \
            tracing.recording():
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    profile_predict.summarize(prof, args.steps, wall_ms, 'step')


if __name__ == '__main__':
    main()
