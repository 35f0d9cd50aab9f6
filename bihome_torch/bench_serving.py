"""Latency of an exported serving artifact (counterpart of
``tools/bench_serving.py``; see ``bihome_torch/serving.py``).

    python -m bihome_torch.bench_serving --artifact model.pt2 [--batch 64]
        [--iters 50] [--warmup 5] [--json]

Loads the artifact (``serving.load_exported``: cuDNN's deterministic
algorithms, no TF32) on the device it was exported for and reports the
steady-state predict latency per batch and pairs/s on random NHWC
patches. On the card: ``--warmup`` calls first, then one synchronize, a
CUDA event before and after the ``--iters`` calls, one synchronize; the
time is the events' over the calls (device time of a queue the host
keeps full, so it includes any host gap it cannot hide). On the CPU: the
host clock around the calls. JAX's loop chains each call's input to the
previous output because the TPU runtime memoises identical executions
(``tools/bench_serving.py:58-74``); CUDA replays nothing, so the inputs
stay as they are. ``--json`` prints one line with JAX's keys
(``metric`` serving_latency_ms, ``value`` in ms per batch, ``unit``,
``batch``, ``pairs_per_s``, ``platform``) plus ``device``, the card's
name (``torch.cuda.get_device_name``) or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bihome_torch import serving


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--artifact', type=str, required=True)
    parser.add_argument('--batch', type=int, default=0,
                        help='batch size (required for polymorphic artifacts)')
    parser.add_argument('--iters', type=int, default=50)
    parser.add_argument('--warmup', type=int, default=5)
    parser.add_argument('--json', action='store_true',
                        help='print one machine-readable JSON line')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    (b, ps, _, ch), _ = serving.exported_input_shapes(args.artifact)
    if not isinstance(b, int):
        if not args.batch:
            raise SystemExit('artifact is batch-polymorphic; pass --batch')
        b = args.batch
    elif args.batch and args.batch != b:
        raise SystemExit(f'artifact is fixed at batch {b}; --batch must '
                         f'match (got {args.batch})')
    predict = serving.load_exported(args.artifact)
    device = predict.device
    rng = np.random.RandomState(0)
    p1, p2 = (torch.from_numpy(rng.randn(b, ps, ps, ch).astype(np.float32))
              .to(device) for _ in range(2))

    for _ in range(args.warmup):
        predict(p1, p2)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            predict(p1, p2)
        end.record()
        torch.cuda.synchronize(device)
        seconds = start.elapsed_time(end) / 1e3
        name = torch.cuda.get_device_name(device)
    else:
        begin = time.perf_counter()
        for _ in range(args.iters):
            predict(p1, p2)
        seconds = time.perf_counter() - begin
        name = 'cpu'
    ms = seconds / args.iters * 1e3
    line = {'metric': 'serving_latency_ms', 'value': ms, 'unit': 'ms/batch',
            'batch': b, 'pairs_per_s': b * args.iters / seconds,
            'platform': 'gpu' if device.type == 'cuda' else 'cpu',
            'device': name}
    if args.json:
        print(json.dumps(line))
    else:
        print(f'{args.artifact}: batch={b} on {name} {ms:.3f} ms/batch  '
              f'{line["pairs_per_s"]:,.0f} pairs/s ({args.iters} iters, '
              f'{args.warmup} warmup)')
    return line


if __name__ == '__main__':
    main()
