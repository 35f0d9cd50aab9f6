"""One run of one cell: parse the arguments, check the card, drive the
cell's traffic, read its metrics and print the result line.

Exit codes: 0 a result printed; 2 bad arguments or files; 3 no card, or
fewer cards than the cell asks for; 4 JAX, flax or the JAX package loaded
in this process; 5 an end-to-end metric with nothing to read."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from benchmark.harness import manifest

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'bihome_tpu')


def parse(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog='benchmark/run.py',
                                description='Run one benchmark cell once.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split('.')[0] in FORBIDDEN})


def device_info(torch, chips: int, peak: int, ctx: Dict) -> Dict[str, Any]:
    info: Dict[str, Any] = {'platform': 'gpu',
                            'kind': torch.cuda.get_device_name(0),
                            'count': chips, 'memory_peak_bytes': int(peak)}
    if 'trace' in ctx:
        info['busy_s'] = ctx['trace']['busy_s']
        info['window_s'] = ctx['trace']['window_s']
    return info


def collect(cell: manifest.Cell, ctx: Dict, trace: bool
            ) -> Optional[Dict[str, Dict[str, Any]]]:
    """Each of the cell's metrics that its reader finds; None where an
    end-to-end metric has nothing to read."""
    out = {}
    for m in cell.metrics(trace):
        value = manifest.reader(m['name'])(ctx)
        if value is None:
            if not trace:
                return None
            continue
        out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def run(argv: Sequence[str], start: float, device=None) -> int:
    """One run; ``device`` given (a test's CPU) skips the look for a card."""
    try:
        args = parse(argv)
        cell = manifest.Cell(manifest.load(), args.workload)
    except (KeyError, FileNotFoundError, ValueError) as err:
        print(f'benchmark: {err}', file=sys.stderr)
        return 2
    import torch
    from benchmark.harness import generators
    if device is None:
        if not torch.cuda.is_available():
            print('benchmark: no CUDA device', file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f'benchmark: the cell asks for {cell.chips} cards, '
                  f'{torch.cuda.device_count()} found', file=sys.stderr)
            return 3
        device = torch.device('cuda', 0)
        torch.set_num_threads(1)
    opts = {'device': device, 'seed': args.seed, 'seconds': args.seconds,
            'trace': bool(args.trace), 'start': start}
    ctx = generators.run_kind(cell.traffic['kind'], cell.config,
                              cell.traffic, opts, cell.limits)
    found = forbidden_modules()
    if found:
        print(f'benchmark: loaded in this process: {", ".join(found)}',
              file=sys.stderr)
        return 4
    metrics = collect(cell, ctx, bool(args.trace))
    if metrics is None:
        print('benchmark: an end-to-end metric found nothing to read',
              file=sys.stderr)
        return 5
    result: Dict[str, Any] = {
        'correct': bool(ctx.get('correct', False)),
        'attempted': int(ctx.get('steps', ctx.get('calls', 0))),
        'failed': 0,
        'metrics': metrics,
        'device': (device_info(torch, cell.chips, ctx['peak_bytes'], ctx)
                   if device.type == 'cuda' else {'platform': device.type}),
    }
    if 'trace' in ctx:
        result['breakdown'] = {'device_ops': ctx['trace']['device_ops'],
                               'idle_gaps': ctx['trace']['idle_gaps']}
    result['checks'] = ctx.get('checks', {})
    print(json.dumps(result), flush=True)
    print(f'readings {json.dumps(ctx.get("readings", {}))}', file=sys.stderr)
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(f'correct {result["correct"]}', file=sys.stderr, flush=True)
    return 0
