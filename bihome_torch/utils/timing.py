"""Kernel timing on the card, shared by chip_smoke.py and the profiles.

:func:`time_ms` reads device time: ``reps`` calls enqueued without
synchronising, each behind a 100 MB write that evicts the 50 MB L2 (no call
finds its inputs warm from the one before) and keeps the card busy while
the host enqueues the next call; a device-side sleep first gives the host
a head start of ``reps`` times its measured enqueue time, so the card never
waits on the host inside a timed window. One pair of CUDA events sits
tightly around each call and there is one synchronize at the end; the
median is reported. :func:`host_us` reads what a call costs the host.
"""

from __future__ import annotations

import statistics
import time

import torch

_STATE = {}


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    if 'cycles' not in _STATE:
        torch.cuda._sleep(1_000_000)                   # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _STATE['cycles'] = 10_000_000 / start.elapsed_time(end)
    return _STATE['cycles']


def _warm(fn, calls: int = 3) -> torch.Tensor:
    """Run ``fn`` ``calls`` times, each behind the L2-evicting write, and
    synchronize; returns the 100 MB buffer of that write."""
    if 'flush' not in _STATE:
        _STATE['flush'] = torch.empty(25_000_000, device='cuda')
    flush = _STATE['flush']
    for _ in range(calls):
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    return flush


def time_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms (see the module
    docstring)."""
    flush = _warm(fn, warmup)
    t0 = time.perf_counter()
    for _ in range(3):
        flush.zero_()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    head_start = min(2000.0, 1.5 * reps * host_ms)
    torch.cuda._sleep(int(head_start * _sleep_cycles_per_ms()))
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_us(fn, calls: int = 200) -> float:
    """Host clock per call of ``fn`` in us over ``calls`` calls enqueued
    without synchronising: what the wrapper costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e6 / calls


def kernel_ms(fn, names, reps: int = 20) -> dict:
    """Device ms per call of ``fn`` of each kernel whose name contains one
    of ``names``, under ``torch.profiler`` (the sum of the kernel's device
    time over ``reps`` calls, each behind the L2-evicting write of
    :func:`time_ms`, divided by ``reps``). Keys are the matching entries
    of ``names``; a kernel of ``fn`` that matches none is left out."""
    flush = _warm(fn)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key:
                out[name] = (out.get(name, 0.0)
                             + e.self_device_time_total / 1e3 / reps)
                break
    return out
