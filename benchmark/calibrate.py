"""Readings for the correctness limits, on the card, at a cell's own
sizes, over many seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control tf32 | --fault unchanged|half_batch|altered] \
        [--seconds 3]

Without ``--control`` it runs the cell's set-up, a short window (one
step for training: the check reads the set-up's steps) and the check for
each seed (the program against the reference; ``--fault``
plants a fault under the timed path) and prints each seed's numbers. With
``--control tf32`` it runs no program: the reference computed with TF32
allowed takes the program's place (three training steps, or the serving
calls of the sampled batches) against the reference at float32. One JSON
line a seed. The benchmark's own runs never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import control, generators, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control', choices=('tf32',))
    p.add_argument('--fault')
    p.add_argument('--seconds', type=float, default=3.0)
    args = p.parse_args(argv)
    cell = manifest.Cell(manifest.load(), args.workload)
    device = torch.device('cuda', 0)
    kind = cell.traffic['kind']
    traffic = dict(cell.traffic)
    if kind == 'train_pool':
        # The check reads the set-up's steps: no warm-up, a one-step window.
        traffic.update(warmup_blocks=0, steps_per_call=1)
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        if args.control:
            ctx = control.KINDS[kind](cell.config, traffic, seed,
                                      device)
        else:
            opts = {'device': device, 'seed': seed, 'seconds': args.seconds,
                    'trace': False, 'start': time.perf_counter(),
                    'fault': args.fault}
            ctx = generators.run_kind(kind, cell.config, traffic, opts,
                                      None)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'control': args.control, 'fault': args.fault,
                          'numbers': ctx['numbers'],
                          'readings': ctx.get('readings'),
                          'setup_s': ctx.get('setup_s'),
                          'seconds': time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
