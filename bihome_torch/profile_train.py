"""Where the training step's time goes on the card.

    python -m bihome_torch.profile_train [--config_file X.yaml]
        [--batch_size 64] [--steps 6] [--set K=V]

Builds the model, optimizer and device pool as ``bihome_torch.train
--synthetic`` does (the synthetic images, seeded backbone, a
PerceptualHead's extractor from ``aux_clfbh.npz``), then runs ``--steps``
calls of the real ``training.trainer.train_step`` on batches drawn on the
device (``trainer.draw_pool_batch``) after two warm-up calls, each split into
phases by CUDA events that hooks record around and inside the call. For
zeng-biHomE (a head with DSAC):

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

The hooks: the backbone's forward pre-hook and hook, gradient hooks on its
outputs (perspective fields or deltas) and, with DSAC, on the corner
deltas (the last of each pair ends its phase), the model's forward hook,
and wrappers of this model's ``dsac_both`` and this optimizer's
``global_norm`` and ``step``. Hooks on the frozen extractor, where the
head has one, time its share of the loss phases (both forward passes; its
input-gradient backward). It then profiles the same steps with
``torch.profiler``: device kernel time and launches per step, the device
idle share of the host-clock window, and the device time by kind of
kernel (each of the port's kernels by name). Needs a CUDA device; it does
not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from bihome_torch import config as config_lib
from bihome_torch import profile_predict, train
from bihome_torch.device import resolve_device
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer

CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
PHASES = ('datagen', 'backbone fwd', 'dsac fwd', 'loss fwd',
          'loss bwd to the deltas', 'dsac bwd', 'backbone bwd', 'optimizer',
          'metrics')
PHASES_NO_DSAC = ('datagen', 'backbone fwd', 'head/loss fwd',
                  'head/loss bwd', 'backbone bwd', 'optimizer', 'metrics')


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


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

    # Phase ends of the step being timed: name -> event. A phase that two
    # gradient hooks end (one per direction) keeps the later event; the
    # optimizer's gradient norm ends the backward at its first call.
    timing = {'on': False}
    marks = {}
    aux_marks = collections.defaultdict(list)

    def mark(name, later=False):
        if timing['on'] and (later or name not in marks):
            marks[name] = _event()

    def grad_mark(name):
        def hook(_grad):
            mark(name, later=True)
        return hook

    dsac = built.needs_dsac_rng
    phases = PHASES if dsac else PHASES_NO_DSAC

    def backbone_done(_module, _inputs, outputs):
        mark('backbone fwd')
        if timing['on']:
            for key in (built.head_cfg.pf_keys if dsac else outputs):
                if outputs[key].requires_grad:   # not FIX_MASK's ones
                    outputs[key].register_hook(grad_mark(
                        'dsac bwd' if dsac else 'head/loss bwd'))
    model.backbone.register_forward_pre_hook(lambda *_: mark('datagen'))
    model.backbone.register_forward_hook(backbone_done)
    model.register_forward_hook(lambda *_: mark(phases[2 + dsac]))
    dsac_both, global_norm, step = (model.dsac_both, optimizer.global_norm,
                                    optimizer.step)

    def timed_dsac_both(*a, **kw):
        deltas = dsac_both(*a, **kw)
        mark('dsac fwd')
        if timing['on']:
            for d in deltas[:2]:
                if d is not None:             # one-line: no 2->1 fit
                    d.register_hook(grad_mark('loss bwd to the deltas'))
        return deltas

    def timed_global_norm():
        mark('backbone bwd')
        return global_norm()

    def timed_step():
        lr = step()
        mark('optimizer')
        return lr
    if dsac:
        model.dsac_both = timed_dsac_both
    optimizer.global_norm = timed_global_norm
    optimizer.step = timed_step

    def aux_hook(kind):
        def hook(*_):
            if timing['on']:
                aux_marks[kind].append(_event())
        return hook
    aux = model.auxiliary_resnet
    if aux is not None:
        aux.register_forward_pre_hook(aux_hook('extractor fwd'))
        aux.register_forward_hook(aux_hook('extractor fwd'))
        aux.register_full_backward_pre_hook(aux_hook('extractor bwd'))
        aux.register_full_backward_hook(aux_hook('extractor bwd'))

    def one_step():
        return trainer.train_step(
            model, optimizer,
            trainer.draw_pool_batch(pool, args.batch_size, draws),
            built.pair_spec, built.loss_name, gen, dsac_gen)

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    events = collections.defaultdict(list)
    host = []
    for _ in range(args.steps):
        start = time.perf_counter()
        timing['on'] = True
        marks.clear()
        aux_marks.clear()
        first = _event()
        one_step()
        mark('metrics')
        timing['on'] = False
        marks['metrics'].synchronize()
        host.append((time.perf_counter() - start) * 1e3)
        ends = [marks[name] for name in phases]
        for name, a, b in zip(phases, [first] + ends[:-1], ends):
            events[name].append(a.elapsed_time(b))
        for kind, evs in aux_marks.items():
            events[kind].append(sum(a.elapsed_time(b) for a, b in
                                    zip(evs[::2], evs[1::2])))
    total = 0.0
    for name in phases:
        ms = statistics.median(events[name])
        total += ms
        print(f'{name}: median {ms:.3f} ms per step (CUDA events)')
    for name, within in (('extractor fwd', f'{phases[2 + dsac]}, both '
                                           'passes'),
                         ('extractor bwd', 'loss bwd, input gradients')):
        if events[name]:
            print(f'  {name}: median {statistics.median(events[name]):.3f} '
                  f'ms per step (within {within})')
    print(f'phases sum {total:.3f} ms; host step {statistics.median(host):.3f}'
          f' ms (median of {args.steps}, each ended by a synchronize); '
          f'pairs/s {args.batch_size / (statistics.median(host) / 1e3):.1f}')

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    profile_predict.summarize(prof, args.steps, wall_ms, 'step')


if __name__ == '__main__':
    main()
