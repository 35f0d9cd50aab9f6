"""One traced block under ``torch.profiler`` and its reduction: the device's
busy time (the union of its kernel, copy and set intervals), the kernel
launches, the time of the program's own kernels, the device operations
that took most time and the longest idle gaps by what the host was doing
meanwhile.

The port's kernels are told apart by name (:data:`PORT_KERNELS`, the
``__global__`` functions of its CUDA sources), and the calls of their
wrappers are logged with their shapes while the block runs
(:func:`log_port_calls`), so that ``benchmark/counts`` can bound them.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from typing import Callable, Dict, List, Tuple

import torch

PORT_KERNELS = ('pf_head_', 'bilinear_sample', 'reduce_rows_kernel')
TOP = 10


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


@contextlib.contextmanager
def log_port_calls(calls: List[Tuple[str, Dict]]):
    """Wrap the program's kernel wrappers so that each call appends
    (kind, shapes) to ``calls``: ``k1`` the PF head forward, ``k2`` its
    backward, ``k3`` a bilinear sample, ``k4`` its point gradient, ``k5``
    its image gradient."""
    from bihome_torch.ops import fused_head, warp
    saved = []

    def wrap(module, name, kind, shapes):
        fn = getattr(module, name)

        def logged(*a, **kw):
            calls.append((kind, shapes(*a, **kw)))
            return fn(*a, **kw)
        # The wrappers count their launches in attributes of their own
        # name: the logged form shares them.
        logged.__dict__ = fn.__dict__
        saved.append((module, name, fn))
        setattr(module, name, logged)

    def dims(t):
        return tuple(t.shape)

    def uv_rows(u):
        return 1 if u.dim() == 2 and u.stride(0) == 0 else u.shape[0]
    wrap(fused_head, 'fused_pf_head_fwd', 'k1',
         lambda x, w1, b1, g, be, w2, *r, **k: {
             'x': dims(x), 'w1': dims(w1), 'w2': dims(w2),
             'bytes_per': x.element_size()})
    wrap(fused_head, 'pf_head_backward', 'k2',
         lambda x, g, w1, b1, ga, be, w2, *r, **k: {
             'x': dims(x), 'w1': dims(w1), 'w2': dims(w2),
             'bytes_per': x.element_size()})
    wrap(warp, 'bilinear_sample_batched', 'k3',
         lambda images, u, v, *r, **k: {
             'images': dims(images), 'points': u.shape[-1],
             'uv_rows': uv_rows(u)})
    wrap(warp, 'bilinear_sample_bwd_uv', 'k4',
         lambda images, u, v, g, *r, **k: {
             'images': dims(images), 'points': u.shape[-1],
             'uv_rows': uv_rows(u)})
    wrap(warp, 'bilinear_sample_bwd_img', 'k5',
         lambda u, v, g, shape, *r, **k: {
             'images': tuple(shape), 'points': u.shape[-1],
             'uv_rows': uv_rows(u)})
    try:
        yield calls
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def profile(block: Callable[[], None]) -> Tuple[object, float]:
    """Run ``block`` under the profiler (CPU and CUDA activity) between two
    synchronizes; returns the profile and the host seconds of the block."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof, wall_s: float) -> Dict:
    """The traced block's device numbers (seconds; names as the profiler
    gives them)."""
    device_events, host_events = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_events.append((e.time_range.start, e.time_range.end,
                                  e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host_events.append((e.time_range.start, e.time_range.end,
                                e.name))
    kernels = [ev for ev in device_events
               if not ev[2].startswith(('Memcpy', 'Memset'))]
    busy = _merge([(a, b) for a, b, _ in device_events])
    by_name: Dict[str, float] = {}
    for a, b, name in device_events:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
            if busy[i + 1][0] > busy[i][1]]
    return {'busy_s': sum(b - a for a, b in busy) * 1e-6,
            'window_s': wall_s,
            'launches': len(kernels),
            'port_kernel_s': sum((b - a) * 1e-6 for a, b, n in kernels
                                 if is_port_kernel(n)),
            'device_s_by_name': by_name,
            'device_ops': sorted(([n[:160], s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            'idle_gaps': _gaps_by_host(gaps, host_events)}


def _gaps_by_host(gaps: List[Tuple[float, float]],
                  host_events: List[Tuple[float, float, str]]
                  ) -> List[List]:
    """The idle gaps' seconds summed by the innermost host operation open
    at each gap's middle (the one that began last), the longest first."""
    host = sorted(host_events)
    by_name: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else '(no host operation)'
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return sorted(([n[:160], s] for n, s in by_name.items()),
                  key=lambda x: -x[1])[:TOP]
