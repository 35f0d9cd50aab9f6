"""What the metric readers of ``benchmark/metrics`` share. Each reads the
run's context and returns a number, or None where the run gives it
nothing to read (then the metric is left out of the line)."""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional, Sequence

PEAKS = json.loads((Path(__file__).resolve().parents[1] / 'counts'
                    / 'peaks.json').read_text())


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile of all ``values``."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def per_unit_ms(ctx: Dict, *spans: str) -> Optional[float]:
    """The window's total of the phase spans over its steps or calls."""
    phases = ctx.get('phases')
    if not phases or not phases.get('units'):
        return None
    return sum(phases[s] for s in spans) / phases['units']


def idle_share(ctx: Dict) -> Optional[float]:
    t = ctx.get('trace')
    if not t or t['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def launches_per_unit(ctx: Dict) -> Optional[float]:
    t = ctx.get('trace')
    return t['launches'] / t['units'] if t else None


def kernel_roofline(ctx: Dict) -> Optional[float]:
    """Sum of the port's kernel calls' bounds over the sum of their kernels'
    measured time, in the traced block; None where none ran."""
    t = ctx.get('trace')
    if not t or t['port_kernel_s'] <= 0 or t['port_bound_s'] <= 0:
        return None
    return 100.0 * t['port_bound_s'] / t['port_kernel_s']


def mfu(ctx: Dict, flops_key: str, units_key: str) -> Optional[float]:
    """The window's counted operations over its seconds, as a share of
    the TF32 peak."""
    if flops_key not in ctx or not ctx.get(units_key):
        return None
    rate = ctx[flops_key] * ctx[units_key] / ctx['window_s']
    return 100.0 * rate / PEAKS['tf32_flops_per_s']
