"""Where the eval path's predict time goes on the card.

    python -m bihome_torch.profile_predict [--config_file X.yaml]
        [--batch_size 64] [--steps 4]

Builds the model and the batches through the eval entry point (synthetic
images, seeded weights), then over ``--steps`` predict calls after one
warm-up measures:

* the backbone and the DSAC fit separately with CUDA events;
* with ``torch.profiler``: device kernel time and kernel launches per
  predict, the device idle share of the host-clock window, and the device
  time grouped by kind of kernel, plus the top kernels by name.

Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import time

import torch

from bihome_torch import eval as teval
from bihome_torch.device import resolve_device

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

    def predict(i, batch, timings=None):
        gen = teval.dsac_generator(seed, i)
        with torch.inference_mode():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            pf = model.backbone(batch)[model.head.pf_keys[0]]
            ev[1].record()
            model.dsac_deltas(pf, generator=gen)
            ev[2].record()
        if timings is not None:
            ev[2].synchronize()
            timings['backbone'].append(ev[0].elapsed_time(ev[1]))
            timings['dsac'].append(ev[1].elapsed_time(ev[2]))

    predict(0, batches[0])
    torch.cuda.synchronize()
    timings = collections.defaultdict(list)
    for i, batch in enumerate(batches):
        predict(i, batch, timings)
    for part in ('backbone', 'dsac'):
        print(f'{part}: median {statistics.median(timings[part]):.3f} ms '
              f'per predict (CUDA events, {len(timings[part])} calls)')

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i, batch in enumerate(batches):
            predict(i, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    summarize(prof, len(batches), wall_ms, 'predict')


def summarize(prof, n: int, wall_ms: float, unit: str) -> None:
    """Print device time, launches and idle share per ``unit`` of a
    profiled window of ``n`` units lasting ``wall_ms`` on the host clock,
    then the device time by kind of kernel and the top kernels."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f'profiled {n} {unit}s: host {wall_ms / n:.3f} ms, device kernels '
          f'{device_us / 1e3 / n:.3f} ms, launches {launches / n:.0f} per '
          f'{unit}; device idle share {1 - device_us / 1e3 / wall_ms:.3f}')
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
