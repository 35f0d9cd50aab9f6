"""Spans and counters at the layer boundaries of the training step and the
serving call: the port's one system for timing its own layers.

    from bihome_torch import tracing

    with tracing.span('train.forward'):        # or @tracing.span(name)
        ...
    tracing.count('copy.h2d', bytes=4096)
    tracing.mark('bwd.backbone')               # a span of no length

    with tracing.recording(device=True) as rec:
        ...                                    # the steps or calls
    rec.spans, rec.counts                      # lists of dicts

Recording is off unless a caller turns it on with :func:`recording`.
Off, a span reads one module attribute and returns a shared object that
does nothing (no clock, no event, no allocation), and a count returns at
once. On, each span records its name, an id, its parent's id, its thread,
the ordinal of the step or call it falls in (the :data:`UNITS` spans
ended before it began) and its host start and end
(``time.perf_counter_ns``). Under a running ``torch.profiler`` a span is
also a ``record_function`` range of its name, so the program's layers
sit in the profiler's trace on the kernels' clock. With ``device=True``
it records a CUDA event at each end too, read when the recording stops:
``device_ms`` (start, end) on the stream, from the recording's start.

Under ``torch.compile`` and ``torch.export`` every span and count is
inert: an exported graph is the same with recording on or off.

Names: ``train.*`` the trainer's phases, ``datagen.*`` pair synthesis,
``model.*`` the model's forward and predict chain, ``dsac.*`` the DSAC
fit, ``serve.call`` one serving call, ``bwd.*`` marks that gradient hooks
make during the backward (:func:`mark_gradients`); the counter
``copy.h2d`` (a host-to-device copy, its ``bytes``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
from time import perf_counter_ns
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

# The spans that make up one step or call: a record's ``unit`` counts how
# many of them had ended when it began.
UNITS = ('train.step', 'serve.call')

_recording: Optional['Recording'] = None


class Recording:
    """What one :func:`recording` collects: ``spans`` (in the order they
    began) and ``counts``, each a dict; ``units``, the :data:`UNITS` spans
    ended."""

    def __init__(self, device: bool = False):
        self.device = bool(device) and torch.cuda.is_available()
        self.spans: List[Dict] = []
        self.counts: List[Dict] = []
        self.units = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._open: Dict[int, Dict] = {}
        self._events: List[Tuple[Dict, torch.cuda.Event,
                                 torch.cuda.Event]] = []
        self._origin = _event() if self.device else None

    def _stack(self) -> List[Dict]:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _current(self, across_threads: bool = True) -> Optional[int]:
        """The id of the span open on this thread, or where none is: with
        ``across_threads`` (a mark or count from a gradient hook on the
        autograd thread) the last one begun and still open on any thread,
        else None."""
        stack = self._stack()
        if stack:
            return stack[-1]['id']
        if not across_threads:
            return None
        with self._lock:
            return next(reversed(self._open), None)

    def _begin(self, name: str, across_threads: bool = True) -> Dict:
        record = {'name': name, 'id': next(self._ids),
                  'parent': self._current(across_threads),
                  'thread': threading.get_ident(),
                  'unit': self.units, 'start_ns': perf_counter_ns(),
                  'end_ns': None}
        self.spans.append(record)
        return record

    def close(self) -> None:
        """Read the device events (waits for the last of them)."""
        if not self._events:
            return
        self._events[-1][2].synchronize()
        for record, start, end in self._events:
            record['device_ms'] = (self._origin.elapsed_time(start),
                                   self._origin.elapsed_time(end))
        self._events.clear()


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Decorates:
    """A span used as a decorator opens a span of its name at each call."""

    __slots__ = ('name',)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Off(_Decorates):
    """What :func:`span` gives while nothing is recorded."""

    __slots__ = ()

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF: Dict[str, _Off] = {}


class _Span(_Decorates):
    __slots__ = ('rec', 'record', 'range', 'start')

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        self.record = record = rec._begin(self.name, across_threads=False)
        rec._stack().append(record)
        with rec._lock:
            rec._open[record['id']] = record
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.start = _event() if rec.device else None
        return None

    def __exit__(self, *exc) -> bool:
        rec, record = self.rec, self.record
        if self.start is not None:
            rec._events.append((record, self.start, _event()))
        if self.range is not None:
            self.range.__exit__(None, None, None)
        record['end_ns'] = perf_counter_ns()
        rec._stack().pop()
        with rec._lock:
            rec._open.pop(record['id'], None)
        if self.name in UNITS:
            rec.units += 1
        return False


def active() -> bool:
    """Whether spans and counts are recorded here: a recording is on, and
    this is not code that ``torch.compile`` or ``torch.export`` traces
    (also to skip work done only for a count's arguments)."""
    return _recording is not None and not torch.compiler.is_compiling()


def span(name: str):
    """A context manager (or a decorator) that records a span ``name``
    while a :func:`recording` is on, and does nothing otherwise."""
    if not active():
        off = _OFF.get(name)
        return off if off is not None else _OFF.setdefault(name, _Off(name))
    return _Span(_recording, name)


def mark(name: str) -> None:
    """A span of no length: a boundary inside a phase that no call
    encloses (a gradient hook on the autograd thread records one)."""
    if not active():
        return
    rec = _recording
    record = rec._begin(name)
    record['end_ns'] = record['start_ns']
    if _profiler._is_profiler_enabled:
        with record_function(name):
            pass
    if rec.device:
        ev = _event()
        rec._events.append((record, ev, ev))


def count(name: str, n: int = 1, **shape) -> None:
    """Count ``n`` of ``name`` inside the current span, with ``shape``
    (sizes, bytes) beside it, while a recording is on."""
    if not active():
        return
    rec = _recording
    rec.counts.append({'name': name, 'n': n, 'span': rec._current(),
                       'thread': threading.get_ident(), 'unit': rec.units,
                       'shape': shape})


def count_copy(device, nbytes: int) -> None:
    """Count a copy of ``nbytes`` from the host to ``device``
    (``copy.h2d``), unless ``device`` is the host."""
    if _recording is not None and device is not None and \
            torch.device(device).type != 'cpu':
        count('copy.h2d', bytes=int(nbytes))


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``, counted by :func:`count_copy` where ``t`` lies on
    the host."""
    if _recording is not None and t.device.type == 'cpu':
        count_copy(device, t.nbytes)
    return t.to(device)


class _GradientMark:
    __slots__ = ('name',)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, _grad):
        mark(self.name)


def mark_gradients(name: str, tensors: Iterable) -> None:
    """While recording, :func:`mark` ``name`` each time a gradient reaches
    one of ``tensors`` (those that require one; None and non-tensors are
    passed over): with several, the last mark of a backward is where the
    gradient has reached them all."""
    if not active():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            t.register_hook(_GradientMark(name))


@contextlib.contextmanager
def recording(device: bool = False) -> Iterator[Recording]:
    """Record spans and counts for the duration (``device``: CUDA events at
    each span's ends too, where there is a card); one at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError('a recording is already on')
    rec = Recording(device)
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        rec.close()


def merge(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The union of intervals, as sorted disjoint [start, end] pairs."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_busy(prof) -> Tuple[float, int]:
    """A profile's device busy seconds, the union of its kernel, copy and
    set intervals (kernels that overlap count once; the ranges that the
    profiler draws on the device for ``record_function`` ranges are none
    of these), and its kernel launches."""
    intervals, launches = [], 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            intervals.append((e.time_range.start, e.time_range.end))
            launches += not e.name.startswith(('Memcpy', 'Memset'))
    return sum(b - a for a, b in merge(intervals)) * 1e-6, launches
