"""The program's spans and counters in a traced run
(``harness/program_spans.py``).

* The reduction on synthetic events: a gap inside nested spans goes to
  the outermost layer's span that names one, a gap in the backward to the
  head and loss before the last ``bwd.backbone`` mark and to the backbone
  after it (the gradient hooks run on the autograd thread), a gap under
  no span to ``none``; host ms and copies a step from records.
* A traced run of a cell on the CPU with the spans recorded over its
  window and its traced block (:func:`run_with_spans`) reads every
  number; the idle ones read 0 (no device, no gaps).
* On the card (``cuda``), at the cells' own traffic: the spans' stream
  times (device timing on) match the phase events of ``harness/phases.py``
  in one zeng b64 run; ``copy.h2d`` equals the traced block's Memcpy HtoD
  events in each step or call (zeng b64 and predict, each in a process of
  its own); in each training cell at least 90% of the traced block's
  device idle time falls under a program span.
"""

import collections
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import generators, manifest, phases, program_spans
from benchmark.harness import trace
from benchmark.tests.conftest import ROOT, SMALL, small_traffic
from bihome_torch import tracing

CUDA = torch.autograd.DeviceType.CUDA
TRAIN = ['pds-zeng-bihome.train-b64', 'pds-detone-orig.train-b128',
         'pds-zeng-bihome.train-b128']


def _event(a, b, name, device=False, annotation=False):
    return SimpleNamespace(
        time_range=SimpleNamespace(start=a, end=b), name=name,
        device_type=CUDA if device else torch.autograd.DeviceType.CPU,
        is_user_annotation=annotation)


def _record(name, start_ms, end_ms, parent=None, unit=0):
    return {'name': name, 'parent': parent, 'unit': unit,
            'start_ns': int(start_ms * 1e6), 'end_ns': int(end_ms * 1e6)}


def test_idle_gaps_go_to_the_span_the_host_was_in():
    # One step (us): datagen.warp inside train.datagen inside train.step;
    # the backward with two marks on the autograd thread (1 and 2), one
    # gap before the last and one after it; the optimizer; then nothing.
    host = [('train.step', 0, 1000, 1), ('train.datagen', 0, 200, 1),
            ('datagen.warp', 100, 200, 1), ('train.forward', 200, 400, 1),
            ('model.backbone', 200, 300, 1), ('model.head', 300, 400, 1),
            ('train.backward', 400, 800, 1), ('bwd.backbone', 500, 501, 2),
            ('bwd.backbone', 600, 601, 2), ('train.optimizer', 800, 900, 1)]
    device = [(0, 140), (160, 250), (270, 310), (340, 540), (560, 640),
              (660, 810), (850, 1000), (1100, 1200)]
    events = [_event(a, b, n) for n, a, b, _ in host]
    events += [_event(a, b, 'kernel', device=True) for a, b in device]
    # The profiler's ranges on the device for the spans are not busy time.
    events.append(_event(0, 1000, 'train.step', True, annotation=True))
    spans, marks, busy = program_spans.profile_events(
        SimpleNamespace(events=lambda: events),
        {n for n, *_ in host})
    assert marks == [500, 600] and len(busy) == len(device)
    by_layer, by_span, idle = program_spans.idle_by_layer(spans, marks, busy)
    assert idle == pytest.approx(250e-6)
    assert by_layer == pytest.approx({
        'datagen': 20e-6,                 # 140-160, under datagen.warp
        'backbone': 20e-6 + 20e-6,        # 250-270; 640-660 after mark 2
        'head_loss': 30e-6 + 20e-6,       # 310-340; 540-560 before mark 2
        'other': 40e-6,                   # 810-850, under train.optimizer
        'none': 100e-6})                  # 1000-1100, under no span
    assert by_span['datagen.warp'] == pytest.approx(20e-6)
    assert by_span['train.backward'] == pytest.approx(40e-6)


def test_host_ms_copies_and_units_from_records():
    window = SimpleNamespace(
        spans=[_record('train.draw', 0, 1), _record('train.step', 1, 11),
               _record('train.datagen', 1, 3, parent=2),
               _record('train.draw', 11, 12, unit=1),
               _record('train.step', 12, 20, unit=1)],
        counts=[{'name': 'copy.h2d', 'n': 1, 'shape': {'bytes': 512}}] * 5
        + [{'name': 'other.count', 'n': 1, 'shape': {}}])
    block = SimpleNamespace(spans=[_record('train.step', 0, 5)], counts=[])
    out = program_spans.reduce('train', window, block,
                               SimpleNamespace(events=lambda: []))
    assert out['units'] == 2 and out['traced_units'] == 1
    assert out['host_ms'] == pytest.approx(10.0)
    assert out['h2d_copies'] == 2.5 and out['h2d_bytes'] == 1280
    assert out['idle_ms'] == {} and out['covered'] == 1.0


def run_with_spans(monkeypatch, workload, device, seconds,
                   device_timing=False, small=False, seed=2 ** 31 + 21):
    """One traced run of ``workload`` through its generator (the cell's
    traffic, or the tests' small one), with the program's spans recorded
    over the measured window (``device_timing``: CUDA events at their
    ends) and over the traced block, under its profiler. Returns (the
    run's context, the window's and the block's recordings, the block's
    profile)."""
    got = {}

    class Spanned(phases.Recorder):
        """The phase marks' switch also switches the recording."""

        @property
        def on(self):
            return self.__dict__.get('_on', False)

        @on.setter
        def on(self, value):
            if value and not self.on:
                self._spans = tracing.recording(device=device_timing)
                got['window'] = self._spans.__enter__()
            elif self.on and not value:
                self._spans.__exit__(None, None, None)
            self.__dict__['_on'] = value

    def spanned(install):
        def installed(*args):
            rec = install(*args)
            rec.__class__ = Spanned
            return rec
        return installed
    for name in ('install_train', 'install_call'):
        monkeypatch.setattr(phases, name, spanned(getattr(phases, name)))
    profile = trace.profile

    def profiled(block):
        with tracing.recording() as rec:
            got['prof'], wall = profile(block)
        got['block'] = rec
        return got['prof'], wall
    monkeypatch.setattr(trace, 'profile', profiled)
    if small:
        small_traffic(monkeypatch)
    cell = manifest.Cell(manifest.load(), workload)
    opts = {'device': device, 'seed': seed, 'seconds': seconds,
            'trace': True, 'start': time.perf_counter()}
    ctx = generators.run_kind(cell.traffic['kind'], cell.config,
                              cell.traffic, opts, cell.limits)
    return ctx, got['window'], got['block'], got['prof']


@pytest.mark.parametrize('workload', ['pds-zeng-bihome.train-b64',
                                      'pds-zeng-bihome.predict-b64'])
def test_a_traced_run_on_the_cpu_reads_every_number(monkeypatch, workload):
    from benchmark.tests.test_bench_harness import _HostEvent
    monkeypatch.setattr(torch.cuda, 'Event', _HostEvent)

    def cpu_profile(block):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            block()
            wall = time.perf_counter() - t0
        return prof, wall
    monkeypatch.setattr(trace, 'profile', cpu_profile)
    monkeypatch.setitem(SMALL, 'trace_steps', 1)
    monkeypatch.setitem(SMALL, 'trace_calls', 1)
    ctx, window, block, prof = run_with_spans(
        monkeypatch, workload, torch.device('cpu'), 0.05, small=True)
    kind = 'train' if 'steps' in ctx else 'serve'
    out = program_spans.reduce(kind, window, block, prof)
    assert out['units'] == ctx.get('steps', ctx.get('calls'))
    assert out['traced_units'] == 1
    assert 0 < out['host_ms'] < 1e3 * ctx['window_s'] / out['units']
    assert out['h2d_copies'] == 0           # nothing leaves the host here
    assert out['idle_ms'] == {} and out['covered'] == 1.0
    names = {e.name for e in prof.events()}
    assert {'model.backbone', 'model.head'} <= names


def _per_unit(window, start, end):
    """Stream ms a step between two boundaries, each (span name, side,
    'first' or 'last' of the step)."""
    total, steps = 0.0, {}
    for s in window.spans:
        steps.setdefault(s['unit'], []).append(s)

    def at(spans, name, side, which):
        times = [s['device_ms'][side] for s in spans if s['name'] == name]
        return times[0] if which == 'first' else times[-1]
    done = [u for u in steps.values()
            if any(s['name'] == 'train.metrics' for s in u)]
    for spans in done:
        total += at(spans, *end) - at(spans, *start)
    return total, len(done)


@pytest.mark.cuda
def test_span_stream_times_match_the_phase_events(card, monkeypatch):
    ctx, window, _, _ = run_with_spans(
        monkeypatch, 'pds-zeng-bihome.train-b64', card, 5.0,
        device_timing=True)
    draw = ('train.draw', 0, 'first')
    fwd0, fwd1 = ('model.backbone', 0, 'first'), ('model.backbone', 1,
                                                  'first')
    head1 = ('bwd.backbone', 0, 'last')
    bwd1, opt1 = ('train.optimizer', 0, 'first'), ('train.optimizer', 1,
                                                   'first')
    spans = {'datagen_ms': [(draw, fwd0)], 'backbone_ms': [
        (fwd0, fwd1), (head1, bwd1)], 'head_loss_ms': [(fwd1, head1)],
        'optimizer_ms': [(bwd1, opt1)]}
    marks = {'datagen_ms': ['start-fwd0'],
             'backbone_ms': ['fwd0-fwd1', 'head1-bwd1'],
             'head_loss_ms': ['fwd1-head1'], 'optimizer_ms': ['bwd1-opt1']}
    p = ctx['phases']
    for metric, pairs in spans.items():
        ms = 0.0
        for a, b in pairs:
            total, n = _per_unit(window, a, b)
            ms += total / n
        want = sum(p[k] for k in marks[metric]) / p['units']
        print(f'{metric}: spans {ms:.4f} ms, phase events {want:.4f} ms')
        assert abs(ms - want) <= max(0.05 * want, 0.5), metric


@pytest.fixture(scope='module',
                params=TRAIN + ['pds-zeng-bihome.predict-b64'])
def traced(request):
    """One traced run of each cell at its own traffic, 10 s of window."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    card = torch.device('cuda', 0)
    with pytest.MonkeyPatch.context() as monkeypatch:
        ctx, window, block, prof = run_with_spans(
            monkeypatch, request.param, card, 10.0)
    kind = 'train' if 'steps' in ctx else 'serve'
    out = program_spans.reduce(kind, window, block, prof)
    unit_ms = 1e3 * ctx['window_s'] / out['units']
    print(f'\n{request.param} on {torch.cuda.get_device_name(card)}: '
          f'{unit_ms:.2f} ms a unit in the window, {out}')
    return SimpleNamespace(workload=request.param, ctx=ctx, out=out,
                           block=block, prof=prof)


def copies_by_unit(ctx, block, prof):
    """Each step or call of a traced block: the ``copy.h2d`` counted in
    it, and the Memcpy HtoD events of the profile that host operations
    inside its span launched (the profiler links each to its operation)."""
    unit = 'train.step' if 'steps' in ctx else 'serve.call'
    units = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name == unit and e.device_type != CUDA)
    profiled = collections.Counter()
    for e in prof.events():
        n = sum('HtoD' in k.name for k in e.kernels)
        if n and e.device_type != CUDA:
            for k, (a, b) in enumerate(units):
                if a <= e.time_range.start <= b:
                    profiled[k] += n
    counted = collections.Counter(c['unit'] for c in block.counts
                                  if c['name'] == 'copy.h2d')
    return [[counted[k], profiled[k]] for k in range(len(units))]


COPIES = """
import json, sys, pytest, torch
from benchmark.tests.test_bench_spans import copies_by_unit, run_with_spans
with pytest.MonkeyPatch.context() as monkeypatch:
    ctx, _, block, prof = run_with_spans(
        monkeypatch, sys.argv[1], torch.device('cuda', 0), 2.0)
print(json.dumps(copies_by_unit(ctx, block, prof)))
"""


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['pds-zeng-bihome.train-b64',
                                      'pds-zeng-bihome.predict-b64'])
def test_counted_copies_are_the_profilers(card, workload):
    """Each step's or call's ``copy.h2d`` equals the profiler's Memcpy HtoD
    events in it, in a process of its own that profiles once, as a run of
    the harness does: a process that profiled several cells lost some of
    the events of its later profiles."""
    done = subprocess.run([sys.executable, '-c', COPIES, workload],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    pairs = json.loads(done.stdout.strip().splitlines()[-1])
    print(f'{workload}: copies a unit, counted and profiled: {pairs}')
    assert len(pairs) > 1 and all(c == p > 0 for c, p in pairs)


@pytest.mark.cuda
def test_idle_time_falls_under_the_programs_spans(traced):
    out = traced.out
    if traced.workload in TRAIN:
        assert out['covered'] >= 0.9, out['idle_ms_by_span']
    assert 0 < out['host_ms']
    assert sum(out['idle_ms'].values()) > 0
