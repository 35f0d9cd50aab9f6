"""The port's spans and counters (``bihome_torch.tracing``) on the CPU.

* Off (the default) a span records nothing, calls no ``record_function``
  and records no CUDA event, even under a running profiler.
* On, one tiny zeng-biHomE training step (32x32 patches, batch 2) and one
  serving call give the span tree of ``tracing``'s names: one
  ``train.step`` a step, ``bwd.backbone`` inside ``train.backward``, the
  DSAC and datagen spans inside their layers; under a CPU profiler the
  spans are events of the same names.
* The exported serving graph is the same with recording on and off.
* ``copy.h2d`` counts copies off the host only, and the profilers print
  them a step or call; a span takes its parent from its own thread, a
  gradient hook's mark from any; the union of busy intervals.
"""

import collections
import threading
from types import SimpleNamespace

import pytest
import torch

from bihome_torch import config as tconfig
from bihome_torch import geometry, profile_predict, serving, tracing
from bihome_torch.models import backbones
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401

ZENG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'


def _tiny_zeng():
    config = tconfig.load_config(ZENG)
    config['MODEL']['HEAD']['PATCH_SIZE'] = 32
    config['DATA']['TRANSFORMS'][0]['HomographyNetPrep'][:2] = [8, 32]
    built = tconfig.build_model(config)
    backbones.init_weights(built.model.backbone,
                           torch.Generator().manual_seed(4))
    optimizer = Optimizer([p for p in built.model.parameters()
                           if p.requires_grad],
                          **tconfig.solver_kwargs(config))
    return built, optimizer


@pytest.fixture(scope='module')
def zeng():
    built, optimizer = _tiny_zeng()
    pool = torch.randint(0, 256, (4, 64, 80, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))
    return SimpleNamespace(built=built, optimizer=optimizer, pool=pool)


def _block(zeng, steps=1, seed=0):
    gens = [torch.Generator().manual_seed(seed + k) for k in range(3)]
    return trainer.pool_train_block(
        zeng.built.model, zeng.optimizer, zeng.pool, steps, 2,
        zeng.built.pair_spec, zeng.built.loss_name, *gens)


def _names(rec):
    return [s['name'] for s in rec.spans]


def _parent_names(rec):
    ids = {s['id']: s['name'] for s in rec.spans}
    return {(s['name'], ids.get(s['parent'])) for s in rec.spans}


def test_off_records_nothing_and_calls_no_record_function(zeng, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError('called while recording is off')
    for name in ('record_function', 'perf_counter_ns', '_event'):
        monkeypatch.setattr(tracing, name, refuse)
    assert not tracing.active()
    assert tracing.span('train.step') is tracing.span('train.step')
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _block(zeng)
    names = {e.name for e in prof.events()}
    assert not names & {'train.step', 'model.backbone', 'dsac.fit'}
    tracing.mark('bwd.backbone')
    tracing.count('copy.h2d', bytes=8)
    monkeypatch.undo()
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == []


def test_span_tree_of_a_train_step(zeng):
    with tracing.recording() as rec:
        _block(zeng, steps=2)
    names = _names(rec)
    assert names.count('train.step') == 2 and names.count('train.draw') == 2
    assert [s['unit'] for s in rec.spans if s['name'] == 'train.step'] == [
        0, 1]
    assert rec.units == 2
    pairs = _parent_names(rec)
    for child, parent in (
            ('train.draw', None), ('train.step', None),
            ('train.datagen', 'train.step'),
            ('datagen.draws', 'train.datagen'),
            ('datagen.photometric', 'train.datagen'),
            ('datagen.warp', 'train.datagen'),
            ('train.forward', 'train.step'),
            ('model.backbone', 'train.forward'),
            ('model.head', 'train.forward'), ('model.dsac', 'model.head'),
            ('dsac.draws', 'model.dsac'), ('dsac.fit', 'model.dsac'),
            ('model.loss', 'model.head'), ('model.extractor', 'model.loss'),
            ('train.loss', 'train.step'), ('train.backward', 'train.step'),
            ('bwd.deltas', 'train.backward'),
            ('bwd.backbone', 'train.backward'),
            ('train.allreduce', 'train.step'),
            ('train.optimizer', 'train.step'),
            ('train.metrics', 'train.step')):
        assert (child, parent) in pairs, child
    # Each step's spans carry its ordinal; a span ends after it begins.
    for s in rec.spans:
        assert s['end_ns'] >= s['start_ns']
    by_unit = collections.Counter(s['unit'] for s in rec.spans
                                  if s['name'] == 'bwd.backbone')
    assert by_unit == {0: 2, 1: 2}       # one mark a field of the pair
    # The later mark falls after the deltas' (the backward's order).
    step0 = [s for s in rec.spans if s['unit'] == 0]
    last = {s['name']: s['start_ns'] for s in step0}
    assert last['bwd.backbone'] >= last['bwd.deltas']


def test_a_serving_call_and_the_profile(zeng):
    module, _ = serving.make_serving_fn(zeng.built, zeng.built.model.eval(),
                                        2)
    p = torch.randn(2, 32, 32, 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            tracing.recording() as rec:
        module(p, p)
    zeng.built.model.train()
    pairs = _parent_names(rec)
    assert {('serve.call', None), ('model.backbone', 'serve.call'),
            ('model.head', 'serve.call'), ('model.dsac', 'model.head'),
            ('dsac.draws', 'model.dsac'), ('dsac.fit', 'model.dsac')} <= pairs
    assert rec.units == 1
    events = collections.Counter(e.name for e in prof.events())
    for name, n in collections.Counter(_names(rec)).items():
        assert events[name] == n, name


def test_spans_of_a_step_are_profiler_events(zeng):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            tracing.recording() as rec:
        _block(zeng)
    events = collections.Counter(e.name for e in prof.events())
    for name, n in collections.Counter(_names(rec)).items():
        assert events[name] == n, name
    assert events['train.step'] == 1 and events['bwd.backbone'] == 2


def test_the_exported_graph_is_the_same_with_recording_on(zeng):
    model = zeng.built.model
    off = serving.export_predict(zeng.built, model, 2)
    with tracing.recording() as rec:
        on = serving.export_predict(zeng.built, model, 2)
    assert rec.spans == [] and rec.counts == []
    assert serving.graph_ops(on) == serving.graph_ops(off)
    assert str(on.graph) == str(off.graph)
    p = torch.randn(2, 32, 32, 1)
    live, _ = serving.make_serving_fn(zeng.built, model.eval(), 2)
    with torch.no_grad():
        want = live(p, p)
    model.train()
    torch.testing.assert_close(on.module()(p, p), want, rtol=0, atol=0)


def test_copies_are_counted_off_the_host_only():
    t = torch.zeros(3, 4)
    with tracing.recording() as rec:
        assert tracing.to_device(t, 'cpu') is t
        moved = tracing.to_device(t, 'meta')
        geometry.image_corners(8, 8, batch_size=2, device='meta')
        geometry.image_corners(8, 8, batch_size=2)
    assert moved.device.type == 'meta'
    assert [(c['name'], c['shape']) for c in rec.counts] == [
        ('copy.h2d', {'bytes': 48}), ('copy.h2d', {'bytes': 32})]


def test_the_profilers_print_the_copies_a_unit():
    t = torch.zeros(3, 4)
    recordings = []
    for k in range(3):
        with tracing.recording() as rec:
            with tracing.span('dsac.draws'):
                for _ in range(2):
                    tracing.to_device(t, 'meta')
            if k:
                tracing.to_device(t[0], 'meta')
        recordings.append(rec)
    assert profile_predict.copies_line(recordings, 'step') == (
        'host-to-device copies: median 3 (112 bytes) per step (copy.h2d, '
        '3 steps); by span: dsac.draws 2, no span 0.666667')
    with tracing.recording() as rec:
        pass
    assert profile_predict.copies_line([rec], 'predict').endswith(
        'median 0 (0 bytes) per predict (copy.h2d, 1 predicts); by span: '
        'none')


def test_decorator_marks_threads_and_one_recording_at_a_time():
    @tracing.span('outer')
    def outer(x):
        with tracing.span('inner'):
            tracing.count('things', 3, size=x)
        return x + 1

    assert outer(1) == 2                    # off: a plain call
    with tracing.recording() as rec:
        assert outer(2) == 3
        with tracing.span('open'):
            t = threading.Thread(target=tracing.mark, args=('elsewhere',))
            t.start()
            t.join(10)
            # A span begun on a thread with none open has no parent.
            top = threading.Thread(target=outer, args=(3,))
            top.start()
            top.join(10)
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert not t.is_alive() and not top.is_alive()
    ids = {s['id']: s['name'] for s in rec.spans}
    parents = [(s['name'], ids.get(s['parent'])) for s in rec.spans]
    assert parents == [('outer', None), ('inner', 'outer'), ('open', None),
                       ('elsewhere', 'open'), ('outer', None),
                       ('inner', 'outer')]
    assert [c['shape'] for c in rec.counts] == [{'size': 2}, {'size': 3}]
    assert rec.counts[0]['n'] == 3
    assert [ids[c['span']] for c in rec.counts] == ['inner', 'inner']
    assert not tracing.active()


def test_mark_gradients_on_the_tensors_that_take_one():
    x = torch.ones(3, requires_grad=True)
    y, frozen = x * 2, torch.ones(3)
    with tracing.recording() as rec:
        tracing.mark_gradients('bwd.y', (y, frozen, None))
        (y.sum() + frozen.sum()).backward()
    assert _names(rec) == ['bwd.y']
    y2 = x * 3
    tracing.mark_gradients('bwd.y', (y2,))   # off: no hook
    assert y2._backward_hooks is None


class _Event:
    def __init__(self, a, b, name, device, annotation=False):
        self.time_range = SimpleNamespace(start=a, end=b)
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


def test_device_busy_is_the_union_of_intervals():
    prof = SimpleNamespace(events=lambda: [
        _Event(0, 10, 'k', True), _Event(5, 20, 'k', True),
        _Event(30, 40, 'Memcpy HtoD', True), _Event(0, 100, 'op', False),
        _Event(0, 100, 'train.step', True, annotation=True)])
    busy_s, launches = tracing.device_busy(prof)
    assert busy_s == pytest.approx(30e-6) and launches == 2
    assert tracing.merge([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]
