"""The generators of traffic, one per ``kind`` of a traffic file, each
driving one cell's run: set-up, the measured window, the traced block
and the check against the plain reference.

``train_pool`` (keys: ``batch``, ``steps_per_call``, ``pool_size``,
``image_hw``, ``checked_steps``, ``warmup_blocks``, ``trace_steps``): the
program's training step on a device pool, as its CLI runs it. Set-up
builds one training object (model, optimizer, pool, generators) and
drives it through ``trainer.pool_train_block``: one step, then the rest of
the checked steps (the readings the check compares), then the warm-up
blocks. The window calls ``pool_train_block`` in blocks of
``steps_per_call`` steps, each ended by one synchronize, until the
window's seconds have passed; it ends at the last block's synchronize.

``predict_closed`` (keys: ``batch``, ``distinct_batches``, ``pool_size``,
``image_hw``, ``warmup_calls``, ``trace_calls``, ``checked_calls``): one
caller in a closed loop on the program's serving module (the live form
of the exported artifact), each call ``batch`` patch pairs, its
``delta_hat`` read back to the host before the next call is sent. The
pairs are synthesized in set-up (``distinct_batches`` batches, sent in
an order drawn from the seed).

Each returns the run's context: what the metric readers of
``benchmark/metrics`` read.
"""

from __future__ import annotations

import copy
import gc
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark.harness import checks, faults, inputs, phases, trace
from benchmark.harness.inputs import sub_seed


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _reset_peak(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device) -> int:
    """The device's peak allocation since :func:`_reset_peak` (0 off the
    card, where the tests drive a run)."""
    if device.type == 'cuda':
        return torch.cuda.max_memory_allocated(device)
    return 0


def _program_config(cfg: Dict, opts: Dict) -> Dict:
    """The configuration the program runs: the cell's, or with
    ``opts['dtype']`` its own lower-precision path (MODEL.DTYPE) switched
    on, for a control."""
    config = copy.deepcopy(cfg['config'])
    if opts.get('dtype'):
        config['MODEL']['DTYPE'] = opts['dtype']
    return config


def _traced(ctx: Dict, block: Callable[[], None], units: int) -> None:
    """Profile ``block`` (``units`` steps or calls) with the port's kernel
    calls logged; the reduction and the bounds go into ``ctx``."""
    from benchmark.counts import kernels
    calls: List = []
    with trace.log_port_calls(calls):
        prof, wall = trace.profile(block)
    red = trace.reduce(prof, wall)
    red['units'] = units
    red['port_bounds'] = [(k, kernels.bound_s(k, s)) for k, s in calls]
    red['port_bound_s'] = sum(b for _, b in red['port_bounds'])
    ctx['trace'] = red


def train_pool(cfg: Dict, traffic: Dict, opts: Dict) -> Dict[str, Any]:
    from bihome_torch import config as config_lib
    from bihome_torch.training import trainer
    from bihome_torch.training.train_state import Optimizer
    device, seed = opts['device'], opts['seed']
    _tf32(False)
    config = _program_config(cfg, opts)
    built = config_lib.build_model(config)
    model = built.model.to(device)
    inputs.seeded_init(model, sub_seed(seed, inputs.WEIGHTS))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    optimizer = Optimizer([p for _, p in named],
                          **config_lib.solver_kwargs(config))
    b = traffic['batch']
    pool = inputs.make_image_pool(traffic['pool_size'],
                                  tuple(traffic['image_hw']),
                                  sub_seed(seed, inputs.POOL), device)
    gens = (torch.Generator(device=device).manual_seed(
        sub_seed(seed, inputs.DRAWS)),
            torch.Generator().manual_seed(sub_seed(seed, inputs.DATAGEN)),
            torch.Generator().manual_seed(sub_seed(seed, inputs.DSAC)))
    states = [g.get_state() for g in gens]
    undo = faults.plant_train(opts.get('fault'), model, optimizer)

    def block(steps: int):
        return trainer.pool_train_block(
            model, optimizer, pool, steps, b, built.pair_spec,
            built.loss_name, *gens)[1]

    before = {n: p.detach().to('cpu', copy=True) for n, p in named}
    _reset_peak(device)
    checked = traffic['checked_steps']
    loss = block(1)
    beta1 = optimizer.adam.defaults['betas'][0]
    grad_norm = {}
    for n, p in named:
        state = optimizer.adam.state.get(p, {})
        grad_norm[n] = (float(torch.linalg.vector_norm(state['exp_avg']))
                        / (1.0 - beta1) if 'exp_avg' in state else 0.0)
    loss += block(checked - 1)
    prog = {'loss': [float(x) for x in loss], 'grad_norm': grad_norm,
            'change_norm': {n: float(torch.linalg.vector_norm(
                p.detach().cpu() - before[n])) for n, p in named}}
    del before
    spc = traffic['steps_per_call']
    for _ in range(traffic['warmup_blocks']):
        block(spc)
    _sync(device)
    ctx: Dict[str, Any] = {'setup_s': time.perf_counter() - opts['start']}
    rec = None
    if opts['trace']:
        rec = phases.install_train(trainer, model, optimizer)
        rec.on = True
    steps = 0
    t0 = time.perf_counter()
    while True:
        block(spc)
        _sync(device)
        steps += spc
        if time.perf_counter() - t0 >= opts['seconds']:
            break
    ctx['window_s'] = time.perf_counter() - t0
    ctx['steps'] = steps
    ctx['pairs'] = steps * b
    ctx['peak_bytes'] = _peak(device)
    if rec is not None:
        rec.on = False
        ctx['phases'] = rec.totals_ms()
        rec.restore()
        n = traffic['trace_steps']
        _traced(ctx, lambda: block(n), n)
    undo()
    del model, optimizer, built
    _free()
    ctx.update(_reference_train(cfg, traffic, opts, pool, states, prog,
                                checked))
    return ctx


def _reference_train(cfg, traffic, opts, pool, states, prog, checked):
    from benchmark.reference import step
    device, seed = opts['device'], opts['seed']
    _tf32(False)
    ref = step.build(copy.deepcopy(cfg['config']))
    ref.model.to(device)
    inputs.seeded_init(ref.model, sub_seed(seed, inputs.WEIGHTS))
    gens = [torch.Generator(device=device), torch.Generator(),
            torch.Generator()]
    for g, s in zip(gens, states):
        g.set_state(s)
    out = step.train_steps(ref, pool, traffic['batch'], checked, *gens)
    numbers = checks.train_gaps(prog, out)
    extra = {'numbers': numbers,
             'readings': {'program_loss': prog['loss'],
                          'reference_loss': out['loss']}}
    if opts['trace']:
        from benchmark.counts import flops
        extra['step_flops'] = flops.train_step_flops(
            ref, pool, traffic['batch'], sub_seed(seed, inputs.DRAWS))
    return extra


def predict_closed(cfg: Dict, traffic: Dict, opts: Dict) -> Dict[str, Any]:
    from bihome_torch import config as config_lib
    from bihome_torch import serving
    from benchmark.reference.data.pipeline import PairSpec
    device, seed = opts['device'], opts['seed']
    _tf32(False)
    config = _program_config(cfg, opts)
    b = traffic['batch']
    pool = inputs.make_image_pool(traffic['pool_size'],
                                  tuple(traffic['image_hw']),
                                  sub_seed(seed, inputs.POOL), device)
    data = config['DATA']
    spec = PairSpec.from_transforms(data.get('TEST_TRANSFORM',
                                             data['TRANSFORMS']))
    nb = traffic['distinct_batches']
    pairs = inputs.patch_pairs(pool, nb, b, spec,
                               sub_seed(seed, inputs.PAIRS))
    del pool
    weights = _served_weights(cfg, seed, device, pairs)
    built = config_lib.build_model(config)
    model = built.model.to(device)
    model.load_state_dict(weights)
    rng_seed = sub_seed(seed, inputs.SERVING)
    module, _ = serving.make_serving_fn(built, model.eval(), b, rng_seed)
    faults.plant_call(opts.get('fault'), module)
    order_gen = torch.Generator().manual_seed(sub_seed(seed, inputs.ORDER))
    order = torch.randint(0, nb, (4096,), generator=order_gen).tolist()
    p1, p2 = pairs['patch_1'], pairs['patch_2']

    def call(k: int) -> torch.Tensor:
        return module(p1[k], p2[k]).cpu()

    _reset_peak(device)
    for i in range(traffic['warmup_calls']):
        call(order[i % len(order)])
    _sync(device)
    ctx: Dict[str, Any] = {'setup_s': time.perf_counter() - opts['start']}
    rec = None
    if opts['trace']:
        rec = phases.install_call(module)
        rec.on = True
    latencies: List[float] = []
    answers: List = []
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < opts['seconds']:
        k = order[i % len(order)]
        sent = time.perf_counter()
        delta = call(k)
        latencies.append(time.perf_counter() - sent)
        answers.append((k, delta))
        i += 1
    ctx['window_s'] = time.perf_counter() - t0
    ctx['calls'] = len(latencies)
    ctx['pairs'] = len(latencies) * b
    ctx['latencies_s'] = latencies
    ctx['peak_bytes'] = _peak(device)
    if rec is not None:
        rec.on = False
        ctx['phases'] = rec.totals_ms()
        n = traffic['trace_calls']
        _traced(ctx, lambda: [call(order[j % len(order)])
                              for j in range(n)], n)
    del module, model, built
    _free()
    ctx.update(_reference_predict(cfg, traffic, opts, pairs, answers,
                                  rng_seed, weights))
    return ctx


def _served_weights(cfg, seed, device, pairs):
    """The served model's weights: the seeded init, with the backbone's BN
    statistics settled over the first batches of the cell's pairs by the
    plain reference (``inputs.settle_batch_norm``), on the CPU."""
    from benchmark.reference import step
    ref = step.build(copy.deepcopy(cfg['config']))
    ref.model.to(device)
    inputs.seeded_init(ref.model, sub_seed(seed, inputs.WEIGHTS))
    batches = []
    for k in range(min(4, pairs['patch_1'].shape[0])):
        batches.append({'patch_1': pairs['patch_1'][k],
                        'patch_2': pairs['patch_2'][k]})
    inputs.settle_batch_norm(ref.model.backbone, batches)
    return {k: v.detach().to('cpu', copy=True)
            for k, v in ref.model.state_dict().items()}


def _reference_predict(cfg, traffic, opts, pairs, answers, rng_seed,
                       weights):
    from benchmark.reference import step
    device, seed = opts['device'], opts['seed']
    _tf32(False)
    ref = step.build(copy.deepcopy(cfg['config']))
    ref.model.to(device)
    ref.model.load_state_dict(weights)
    b = traffic['batch']
    uniforms = step.serving_uniforms(ref, b, rng_seed)
    pick = torch.Generator().manual_seed(sub_seed(seed, inputs.SAMPLE))
    sample = torch.randperm(len(answers), generator=pick)[
        :traffic['checked_calls']].tolist()
    ref_delta: Dict[int, torch.Tensor] = {}
    gap = 0.0
    for j in sample:
        k, delta = answers[j]
        if k not in ref_delta:
            ref_delta[k] = step.predict(ref, pairs['patch_1'][k],
                                        pairs['patch_2'][k], uniforms).cpu()
        gap = max(gap, float((delta - ref_delta[k]).abs().max()))
    scale = statistics.median(float(d.abs().max())
                              for d in ref_delta.values())
    extra = {'numbers': {'delta_gap_px': gap,
                         'delta_gap_rel': gap / max(scale, 1e-30)},
             'readings': {'checked_calls': len(sample),
                          'reference_max_abs_delta_px': scale}}
    if opts['trace']:
        from benchmark.counts import flops
        extra['call_flops'] = flops.predict_flops(
            ref, pairs['patch_1'][0], pairs['patch_2'][0], uniforms)
    return extra


KINDS = {'train_pool': train_pool, 'predict_closed': predict_closed}


def run_kind(kind: str, cfg: Dict, traffic: Dict, opts: Dict,
             limits: Optional[Dict]) -> Dict[str, Any]:
    """Drive one cell and judge its numbers against ``limits``."""
    if kind not in KINDS:
        raise ValueError(f'unknown traffic kind {kind!r}; known: '
                         f'{sorted(KINDS)}')
    ctx = KINDS[kind](cfg, traffic, opts)
    if limits is not None:
        ctx['checks'] = checks.judge(ctx['numbers'], limits)
        ctx['correct'] = checks.passed(ctx['checks'])
    return ctx
