"""Helpers of the port's multi-rank CPU tests: spawn R ranks on gloo, run
a worker function in each, collect each rank's result. The workers import
only ``bihome_torch`` (no JAX), so a rank starts in a few seconds."""

from __future__ import annotations

import contextlib
import multiprocessing
import queue
import socket
import traceback
from typing import Any, Callable, List

import numpy as np
import torch

RANK_TIMEOUT_S = 240


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn: Callable, args: tuple,
           out, join: bool) -> None:
    try:
        torch.set_num_threads(1)
        if not join:
            out.put((rank, 'ok', fn(rank, world, port, *args)))
            return
        torch.distributed.init_process_group(
            'gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=world,
            rank=rank)
        try:
            result = fn(rank, world, *args)
        finally:
            torch.distributed.destroy_process_group()
        out.put((rank, 'ok', result))
    except BaseException:       # reported to the parent, which raises
        out.put((rank, 'error', traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, join: bool = True
              ) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined by a
    gloo process group; their results in rank order. Without ``join``,
    ``fn(rank, world, port, *args)`` starts the group itself, at
    127.0.0.1:port. Raises if a rank fails or does not finish within
    RANK_TIMEOUT_S."""
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, fn, args, out, join))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, status, value = out.get(timeout=RANK_TIMEOUT_S)
            if status == 'ok':
                results[rank] = value
            else:
                errors.append(f'rank {rank}:\n{value}')
                break
    except queue.Empty:
        errors.append('a rank did not finish in time')
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError('\n'.join(errors))
    return [results[r] for r in range(world)]


def numpy_tree(x):
    """Tensors of a nested dict/list/tuple as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    return x


# -- workers of tests/test_torch_dist_stats.py ------------------------------

BN_FAULTS = ('statistics local', 'cotangent sums local',
             'dgamma from summed sums')
HEAD_FAULTS = ('statistics local', 'k0 k1 from local moments',
               'dw2 dgamma from summed moments')


def stats_inputs(seed: int = 0):
    """float64 inputs of the BN and the PF head cases, whole batch: BN x
    [8,6,5,5] with its cotangent, the head's x [4,16,6,6] and cotangent,
    and their parameters."""
    rs = np.random.RandomState(seed)
    bn = {'x': rs.randn(8, 6, 5, 5) * 1.5 + 0.7,
          'g': rs.randn(8, 6, 5, 5),
          'weight': 1.0 + 0.3 * rs.randn(6), 'bias': 0.2 * rs.randn(6)}
    cin, cmid = 16, 32
    head = {'x': rs.randn(4, cin, 6, 6), 'g': rs.randn(4, 2, 6, 6),
            'w1': rs.randn(cmid, cin, 1, 1) * 0.3, 'b1': rs.randn(cmid) * 0.2,
            'gamma': 1.0 + 0.2 * rs.randn(cmid),
            'beta': 0.3 + 0.1 * rs.randn(cmid),
            'w2': rs.randn(2, cmid, 1, 1) * 0.3, 'b2': 0.1 * rs.randn(2)}
    return bn, head


@contextlib.contextmanager
def planted(fault: str, part: str):
    """Each wrong split of the statistics across ranks, planted by
    replacing the seam that makes it."""
    from bihome_torch.models import norm
    from bihome_torch.ops import fused_head
    from bihome_torch.parallel import mesh
    patches = []
    if fault == 'statistics local':
        patches.append((mesh, 'sum_over_ranks', lambda *t: list(t)))
    elif part == 'bn':
        orig = norm.cotangent_sums
        pick = {'cotangent sums local': lambda loc, glob: (loc, loc),
                'dgamma from summed sums': lambda loc, glob: (glob, glob)}
        patches.append((norm, 'cotangent_sums',
                        lambda g, xh: pick[fault](*orig(g, xh))))
    elif part == 'head':
        orig = fused_head.moment_sums

        def spoiled(m0, m1, m, device):
            loc, (gm0, gm1, gm) = orig(m0, m1, m, device)
            if fault == 'k0 k1 from local moments':
                return loc, (m0, m1, torch.full_like(gm, float(m)))
            return (gm0, gm1), (gm0, gm1, gm)
        patches.append((fused_head, 'moment_sums', spoiled))
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def bn_case(x, g, weight, bias, fault=None, part='bn'):
    """The port's BatchNorm2d in training mode on x (float64): output, dx,
    the parameter gradients summed over the ranks (the trainer's
    reduction of a loss that sums over the batch), the running stats."""
    from bihome_torch.models.norm import BatchNorm2d
    from bihome_torch.parallel import mesh
    bn = BatchNorm2d(x.shape[1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    with planted(fault, part) if fault else contextlib.nullcontext():
        y = bn(xt)
        (y * torch.from_numpy(g)).sum().backward()
    mesh.all_reduce_grads(list(bn.parameters()), 1.0)
    return numpy_tree({'y': y, 'dx': xt.grad, 'dgamma': bn.weight.grad,
                       'dbeta': bn.bias.grad, 'mean': bn.running_mean,
                       'var': bn.running_var})


def head_case(x, g, w1, b1, gamma, beta, w2, b2, fault=None):
    """The port's PFHead (plain path) in training mode on x (float64), as
    :func:`bn_case` reads it (gradients in torch layouts)."""
    from bihome_torch.models.backbones import PFHead
    from bihome_torch.parallel import mesh
    head = PFHead(x.shape[1], w1.shape[0]).double().train()
    conv1, bn, _, conv2 = head
    with torch.no_grad():
        for p, v in ((conv1.weight, w1), (conv1.bias, b1), (bn.weight, gamma),
                     (bn.bias, beta), (conv2.weight, w2), (conv2.bias, b2)):
            p.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    with planted(fault, 'head') if fault else contextlib.nullcontext():
        y = head(xt)
        (y * torch.from_numpy(g)).sum().backward()
    mesh.all_reduce_grads(list(head.parameters()), 1.0)
    grads = {name: p.grad for name, p in head.named_parameters()}
    return numpy_tree({'y': y, 'dx': xt.grad, **grads,
                       'mean': bn.running_mean, 'var': bn.running_var})


def stats_worker(rank: int, world: int, seed: int):
    """Every case of the statistics test on this rank's contiguous slice."""
    bn, head = stats_inputs(seed)

    def part(d, keys):
        out = dict(d)
        for k in keys:
            n = d[k].shape[0] // world
            out[k] = np.ascontiguousarray(d[k][rank * n:(rank + 1) * n])
        return out
    bn, head = part(bn, ('x', 'g')), part(head, ('x', 'g'))
    out = {('bn', None): bn_case(**bn), ('head', None): head_case(**head)}
    for fault in BN_FAULTS:
        out[('bn', fault)] = bn_case(**bn, fault=fault)
    for fault in HEAD_FAULTS:
        out[('head', fault)] = head_case(**head, fault=fault)
    return out


# -- workers of tests/test_torch_ddp_step.py --------------------------------

def one_step(config, state, images, corners, delta, uniforms, seed=None):
    """One ``trainer.train_step`` of the model of ``config`` from
    ``state`` on this rank's slice of the injected global draws (the
    whole of them in one process), or with ``seed`` on this rank's slice
    of ``images`` with no draw injected: the step draws from generators
    seeded from ``seed``, as training does. Returns the global metrics,
    the gradients after the all-reduce and the parameters after Adam
    (numpy)."""
    from bihome_torch import config as tconfig
    from bihome_torch.models import weights
    from bihome_torch.parallel import mesh
    from bihome_torch.training import trainer
    from bihome_torch.training.train_state import Optimizer
    built = tconfig.build_model(config)
    model = built.model
    weights.load_state_dict(model, {k: torch.from_numpy(v)
                                    for k, v in state.items()})
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    **tconfig.solver_kwargs(built.config))
    shard = (lambda a: torch.from_numpy(np.ascontiguousarray(
        mesh.shard_batch(a))))
    if seed is None:
        draws = {'corners': shard(corners), 'delta': shard(delta),
                 'uniforms': [shard(u) for u in uniforms]}
    else:
        draws = {'datagen_generator': torch.Generator().manual_seed(seed),
                 'dsac_generator': torch.Generator().manual_seed(seed + 1)}
    metrics = trainer.train_step(
        model, opt, shard(images).to(torch.uint8), built.pair_spec,
        built.loss_name, **draws)
    metrics = trainer.global_metrics(metrics, built.loss_name)
    return numpy_tree({
        'metrics': {k: v for k, v in metrics.items()},
        'grads': {n: p.grad for n, p in model.backbone.named_parameters()},
        'params': {n: p for n, p in model.backbone.named_parameters()},
        'stats': {n: b for n, b in model.backbone.named_buffers()}})


def ddp_step_worker(rank: int, world: int, injected, *drawn):
    """The step on this rank with the draws injected (``injected``, the
    arguments of :func:`one_step`) and drawn (each of ``drawn``: a config,
    a state, the images and a seed)."""
    out = {'injected': one_step(*injected)}
    for i, (config, state, images, seed) in enumerate(drawn):
        out[f'drawn{i}'] = one_step(config, state, images, None, None, None,
                                    seed)
    return out


def pair_rows_worker(rank: int, world: int, images, spec, seed: int):
    """``pipeline.generate_pairs`` on this rank's rows of ``images`` with
    the global batch's draws from a generator seeded by ``seed`` (numpy)."""
    from bihome_torch.data import pipeline
    from bihome_torch.parallel import mesh
    total = images.shape[0]
    lo, hi = mesh.shard_range(total, world, rank)
    batch = pipeline.generate_pairs(
        torch.from_numpy(images[lo:hi]), spec,
        torch.Generator().manual_seed(seed), rows=(lo, total))
    return numpy_tree(batch)


def pool_draw_worker(rank: int, world: int, pool_rows: int, batch: int,
                     seed: int):
    """What ``trainer.draw_pool_batch`` gives this rank from a pool of
    ``pool_rows`` labelled rows: without ``pool_shard`` (every rank holds
    the pool and the same generator), and with it (this rank's shard of
    rows and its own generator, as ``train.make_feeds`` builds them); and
    the error of a batch that the ranks do not divide."""
    from bihome_torch.data import pipeline
    from bihome_torch.parallel import mesh
    from bihome_torch.training import trainer
    pool = torch.arange(pool_rows).reshape(pool_rows, 1, 1, 1)
    whole = trainer.draw_pool_batch(
        pool, batch, torch.Generator().manual_seed(seed))
    size = pool_rows - pool_rows % world
    rows = slice(*mesh.shard_range(size, world, rank))
    sharded = trainer.draw_pool_batch(
        pool[rows], batch,
        torch.Generator().manual_seed(pipeline.sample_seed(seed, rank)),
        pool_shard=True)
    try:
        trainer.draw_pool_batch(pool, batch + 1,
                                torch.Generator().manual_seed(seed))
        error = None
    except ValueError as e:
        error = str(e)
    return {'whole': whole.reshape(-1).numpy(), 'rows': (rows.start,
                                                          rows.stop),
            'sharded': sharded.reshape(-1).numpy(), 'error': error}


# -- workers of tests/test_torch_multihost_cli.py ---------------------------

def init_worker(rank: int, world: int, port: int):
    """What ``parallel.mesh.init_from_args`` gives a rank started as the
    entry points' ``--multihost --coordinator 127.0.0.1:port`` start it,
    on the CPU: the device, the backend, world and rank, and a sum over
    the ranks through the group."""
    import argparse

    from bihome_torch.parallel import dist_util, mesh
    device = mesh.init_from_args(argparse.Namespace(
        device='cpu', multihost=True, coordinator=f'127.0.0.1:{port}',
        num_processes=world, process_id=rank))
    try:
        summed, = mesh.sum_over_ranks(torch.tensor([rank + 1.0]))
        return {'device': str(device),
                'backend': torch.distributed.get_backend(),
                'world': dist_util.get_world_size(),
                'rank': dist_util.get_rank(), 'sum': float(summed[0])}
    finally:
        torch.distributed.destroy_process_group()


def dist_util_worker(rank: int, world: int, cache_dir: str):
    """``dist_util`` and ``model_zoo`` as a rank sees them: world, rank,
    main-process test, a barrier, every rank's data gathered, and a cached
    URL resolved behind rank 0's check."""
    from bihome_torch.parallel import dist_util
    from bihome_torch.utils import model_zoo
    dist_util.synchronize()
    return {'world': dist_util.get_world_size(), 'rank': dist_util.get_rank(),
            'main': dist_util.is_main_process(),
            'gathered': dist_util.all_gather(
                {'rank': rank, 'maces': np.arange(3.0) + 10 * rank}),
            'resolved': model_zoo.resolve_weights(
                'https://example.com/models/w.pth', cache_dir)}
