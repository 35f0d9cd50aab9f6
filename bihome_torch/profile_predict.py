"""Where the eval path's predict time goes on the card.

    python -m bihome_torch.profile_predict [--config_file X.yaml]
        [--batch_size 64] [--steps 4]

Builds the model and the batches through the eval entry point (synthetic
images, seeded weights), then over ``--steps`` predict calls after one
warm-up measures:

* the backbone and the fit of its output separately, from the
  program's spans (``model.backbone``, ``model.head``) recorded with a
  CUDA event at each end: the DSAC fit (zeng-biHomE), the RANSAC fit
  (zeng-orig, with the peak device memory of the fit alone), or none (the
  heads whose backbone regresses the deltas);
* the host-to-device copies a predict (``copy.h2d`` counts), their
  bytes and the spans that make them;
* with ``torch.profiler``, the spans on: device busy time (the union of
  its busy intervals) and kernel launches per predict, the device idle
  share of the host-clock window, and the device time grouped by kind of
  kernel, plus the top kernels by name.

Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from bihome_torch import eval as teval
from bihome_torch import tracing
from bihome_torch.device import resolve_device
from bihome_torch.heads import ransac
from bihome_torch.heads.assembled import needs_dsac, needs_ransac

CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
# First match wins: the port's kernels by name (K4/K5 before K3, whose
# name they extend), cuDNN's batch-norm kernels before its conv kernels.
# cuDNN runs some convs as FFTs (fft2d_*, pointwise_mult_and_sum_complex)
# and the transposed convs as dgrad kernels.
GROUPS = (('pf_head_fwd', 'PF head kernel (K1)'),
          ('pf_head_bwd', 'PF head backward kernel (K2)'),
          ('reduce_rows', 'PF head backward kernel (K2)'),
          ('bilinear_sample_bwd_uv', 'warp backward kernel (K4)'),
          ('bilinear_sample_bwd_img', 'warp image-gradient kernel (K5)'),
          ('bilinear_sample', 'warp kernel (K3)'),
          ('multi_tensor_apply', 'optimizer'),
          ('bn_fw', 'batch norm'), ('bn_bw', 'batch norm'),
          ('batch_norm', 'batch norm'),
          ('max_pool', 'max-pool'),
          ('conv', 'convolutions'), ('gemm', 'convolutions'),
          ('xmma', 'convolutions'), ('cudnn', 'convolutions'),
          ('cutlass', 'convolutions'), ('fft', 'convolutions'),
          ('pointwise_mult_and_sum_complex', 'convolutions'))


def _group(name: str) -> str:
    low = name.lower()
    for pattern, group in GROUPS:
        if pattern in low:
            return group
    return 'elementwise and other'


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config_file', default=CONFIG)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--steps', type=int, default=4)
    args = parser.parse_args(argv)
    device = resolve_device('cuda')
    print(f'device {torch.cuda.get_device_name(device)}')
    run = teval.main(['--config_file', args.config_file, '--synthetic',
                      '--batch_size', str(args.batch_size), '--steps',
                      str(args.steps), '--skip_timing', '--device', 'cuda'])
    model, batches = run['model'], run['batches']
    seed = run['test_seed']
    head = model.head
    fit = ('ransac' if needs_ransac(head) else 'dsac' if needs_dsac(head)
           else None)
    gen_device = device if model.draws_on_device else torch.device('cpu')

    def predict(i, batch):
        gen = teval.dsac_generator(seed, i, gen_device)
        with torch.inference_mode():
            model.predict_delta(batch, generator=gen)

    predict(0, batches[0])
    torch.cuda.synchronize()
    timings = collections.defaultdict(list)
    recordings = []
    for i, batch in enumerate(batches):
        with tracing.recording(device=True) as rec:
            predict(i, batch)
        recordings.append(rec)
        for s in rec.spans:
            if s['name'] in ('model.backbone', 'model.head'):
                timings[s['name']].append(s['device_ms'][1]
                                          - s['device_ms'][0])
    print(f'fit of the backbone\'s output (model.head): {fit or "none"}')
    for part, values in timings.items():
        print(f'{part}: median {statistics.median(values):.3f} ms per '
              f'predict (spans, CUDA events, {len(values)} calls)')
    print(copies_line(recordings, 'predict'))
    if fit == 'ransac':
        with torch.inference_mode():
            pf = model.backbone(batches[0])[head.learning_keys[1]]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            gen = teval.dsac_generator(seed, 0, gen_device)
            ransac.perspective_field_to_delta(pf, generator=gen)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f'ransac peak device memory {peak / 1e9:.3f} GB above the '
              f'{base / 1e9:.3f} GB held (batch {args.batch_size}, '
              f'{ransac.NUM_HYPOTHESES} hypotheses x '
              f'{pf.shape[1] * pf.shape[2]} points)')

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, \
            tracing.recording():
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i, batch in enumerate(batches):
            predict(i, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    summarize(prof, len(batches), wall_ms, 'predict')


def copies_line(recordings, unit: str) -> str:
    """The host-to-device copies (``copy.h2d`` counts) a ``unit``, the
    median over ``recordings`` of one unit each: their number and bytes,
    and the number under each span that makes them."""
    totals, places = [], collections.Counter()
    for rec in recordings:
        names = {s['id']: s['name'] for s in rec.spans}
        copies = [c for c in rec.counts if c['name'] == 'copy.h2d']
        totals.append((sum(c['n'] for c in copies),
                       sum(c['shape']['bytes'] for c in copies)))
        for c in copies:
            places[names.get(c['span'], 'no span')] += c['n']
    n = statistics.median(t[0] for t in totals)
    nbytes = statistics.median(t[1] for t in totals)
    where = ', '.join(f'{name} {k / len(totals):g}'
                      for name, k in sorted(places.items()))
    return (f'host-to-device copies: median {n:g} ({nbytes:g} bytes) per '
            f'{unit} (copy.h2d, {len(totals)} {unit}s); by span: '
            f'{where or "none"}')


def summarize(prof, n: int, wall_ms: float, unit: str) -> None:
    """Print device busy time (the union of its busy intervals,
    ``tracing.device_busy``), launches and idle share per ``unit`` of a
    profiled window of ``n`` units lasting ``wall_ms`` on the host clock,
    then the device time by kind of kernel and the top kernels."""
    busy_s, launches = tracing.device_busy(prof)
    device_ms = busy_s * 1e3
    print(f'profiled {n} {unit}s: host {wall_ms / n:.3f} ms, device busy '
          f'{device_ms / n:.3f} ms, launches {launches / n:.0f} per '
          f'{unit}; device idle share {1 - device_ms / wall_ms:.3f}')
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        print('the profiler recorded no device time')
        return
    groups = collections.Counter()
    counts = collections.Counter()
    for e in kernels:
        groups[_group(e.key)] += e.self_device_time_total
        counts[_group(e.key)] += e.count
    for group, us in groups.most_common():
        print(f'  {group}: {us / 1e3 / n:.3f} ms, {counts[group] / n:.0f} '
              f'launches per {unit} ({us / device_us:.1%})')
    print('top kernels by device time:')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {e.self_device_time_total / 1e3 / n:8.3f} ms '
              f'{e.count / n:5.0f}x  {e.key[:100]}')

if __name__ == '__main__':
    main()
