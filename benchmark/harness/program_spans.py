"""The program's own spans and counters (``bihome_torch.tracing``) in a
traced run, reduced to per-layer numbers: the host's ms a step or call and
the host-to-device copies a step, from a recording of the measured window;
the device's idle ms a step or call by the layer the host was in, from a
recording of the traced block and its profile.

An idle gap, a gap between the device's busy intervals (the union of its
kernel, copy and set intervals, as ``trace.reduce`` takes them), is put
down to the innermost program span open at the gap's middle, on any
thread, and through it to a layer: the first span, from the innermost
outwards, that :data:`LAYERS` names. ``train.backward`` is split at its
last ``bwd.backbone`` mark (the gradient has then reached every output of
the backbone): before it the head and loss backward, after it the
backbone's. Under a profiler each span is a ``record_function`` range of
its name, so the spans and the kernels share the profiler's clock.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from bihome_torch import tracing

LAYERS = {'train.draw': 'datagen', 'train.datagen': 'datagen',
          'model.backbone': 'backbone', 'model.head': 'head_loss',
          'train.loss': 'head_loss'}
SPLIT, MARK = 'train.backward', 'bwd.backbone'
# The top-level spans of a step and of a call: the host's time in them.
HOST = {'train': ('train.draw', 'train.step'), 'serve': ('serve.call',)}
TOP = 10

Span = Tuple[float, float, str]


def units(spans: Iterable[Dict]) -> int:
    """The steps or calls a recording holds."""
    return sum(1 for s in spans if s['name'] in tracing.UNITS)


def host_ms(spans: Iterable[Dict], names: Sequence[str]) -> float:
    """The host's ms in the top-level spans named ``names``."""
    return sum(s['end_ns'] - s['start_ns'] for s in spans
               if s['parent'] is None and s['name'] in names) * 1e-6


def copies(counts: Iterable[Dict]) -> Tuple[int, int]:
    """The host-to-device copies counted, and their bytes."""
    h2d = [c for c in counts if c['name'] == 'copy.h2d']
    return (sum(c['n'] for c in h2d),
            sum(c['shape'].get('bytes', 0) for c in h2d))


def profile_events(prof, names: Iterable[str]
                   ) -> Tuple[List[Span], List[float], List[Tuple[float,
                                                                  float]]]:
    """From a profile (times in us): the host events of the spans named
    ``names`` (start, end, name), the times of the :data:`MARK` marks, and
    the device's busy intervals (its events, less the ranges the profiler
    draws on the device for ``record_function`` ranges)."""
    names = set(names)
    spans, marks, busy = [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                busy.append((a, b))
        elif e.name == MARK:
            marks.append(a)
        elif e.name in names:
            spans.append((a, b, e.name))
    return spans, marks, busy


def idle_by_layer(spans: List[Span], marks: List[float],
                  busy: List[Tuple[float, float]]
                  ) -> Tuple[Dict[str, float], Dict[str, float], float]:
    """The device's idle seconds between its busy intervals by layer
    (``'other'`` for a gap under spans of no layer, ``'none'`` for one
    under no span at all), by innermost span, and in all."""
    merged = tracing.merge(busy)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    split = {}
    for a, b, name in spans:
        if name == SPLIT:
            inside = [t for t in marks if a <= t <= b]
            split[(a, b)] = max(inside) if inside else b
    ordered = sorted(spans)
    by_layer: Dict[str, float] = {}
    by_span: Dict[str, float] = {}
    active: List[Span] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid, idle = 0.5 * (a + b), (b - a) * 1e-6
        while i < len(ordered) and ordered[i][0] <= mid:
            active.append(ordered[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        inner = sorted(active, reverse=True)
        name = inner[0][2] if inner else 'none'
        by_span[name] = by_span.get(name, 0.0) + idle
        layer = 'none' if not inner else 'other'
        for s in inner:
            if s[2] == SPLIT:
                layer = ('backbone' if mid > split[(s[0], s[1])]
                         else 'head_loss')
                break
            if s[2] in LAYERS:
                layer = LAYERS[s[2]]
                break
        by_layer[layer] = by_layer.get(layer, 0.0) + idle
    return by_layer, by_span, sum((b - a) * 1e-6 for a, b in gaps)


def reduce(kind: str, window, block, prof) -> Dict:
    """The per-layer numbers of a traced run of ``kind`` ('train' or
    'serve'): ``window`` and ``block`` the recordings of the measured
    window and of the traced block, ``prof`` the block's profile. Per
    step or call: ``host_ms``, ``h2d_copies`` and ``h2d_bytes`` (the
    window's), ``idle_ms`` by layer and ``idle_ms_by_span`` (the longest
    first; the block's); ``covered``, the share of the block's idle time
    under some program span."""
    n = max(units(window.spans), 1)
    copied, nbytes = copies(window.counts)
    names = {s['name'] for s in block.spans}
    by_layer, by_span, idle = idle_by_layer(*profile_events(prof, names))
    m = max(units(block.spans), 1)
    return {'units': n, 'traced_units': m,
            'host_ms': host_ms(window.spans, HOST[kind]) / n,
            'h2d_copies': copied / n, 'h2d_bytes': nbytes / n,
            'idle_ms': {k: 1e3 * v / m for k, v in by_layer.items()},
            'idle_ms_by_span': sorted(([k, 1e3 * v / m]
                                       for k, v in by_span.items()),
                                      key=lambda x: -x[1])[:TOP],
            'covered': (1.0 - by_span.get('none', 0.0) / idle
                        if idle > 0 else 1.0)}
