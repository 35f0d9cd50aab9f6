"""Data parallelism over ranks (counterpart of ``bihome_tpu/parallel/
mesh.py`` and of ``train.py:163-185, 432-449``).

JAX runs one SPMD program over a 'data' mesh: the batch is sharded, the
state replicated, and XLA reduces every batch statistic and the gradients
over the devices. The port runs one process per rank
(``torch.distributed``), each on its contiguous slice of the global
batch (:func:`shard_range`):

* :func:`init_from_args` starts the process group of ``--multihost``:
  with ``--coordinator host:port --num_processes N --process_id R`` at
  ``tcp://host:port`` (JAX's explicit coordinator), without them through
  torchrun's ``env://`` (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT),
  the analogue of JAX's TPU auto-discovery. Before the group starts, the
  ranks tell each other their host's name and cards through the
  rendezvous store (:func:`host_layout`), so every rank knows its local
  rank (the device is ``cuda:local rank``, modulo the host's cards) and
  all take one backend (:func:`choose_backend`): NCCL where every rank
  has a card of its own, gloo on the CPU and where ranks share a card
  (NCCL refuses two ranks on one device).
* :func:`sum_over_ranks` sums small statistics over the ranks in one
  collective: the batch norms' and the PF head's batch statistics and
  their cotangent sums (``models/norm.py``, ``ops/fused_head.py``), so
  that they are the global batch's, as in JAX's sharded step.
* :func:`all_reduce_grads` sums the parameter gradients over the ranks in
  one collective and scales them (see ``training/trainer.py``).
* :func:`gather_over_ranks` concatenates every rank's slice of a batch:
  the blob occlusion's donors are rows of the global batch's patch_1
  (``data/pipeline.generate_pairs``).

Each is a no-op in one process.
"""

from __future__ import annotations

import os
import socket
from collections import Counter
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from bihome_torch.device import resolve_device
from bihome_torch.parallel.dist_util import get_rank, get_world_size

Tensor = torch.Tensor


def add_arguments(parser) -> None:
    """``--multihost``, ``--coordinator``, ``--num_processes`` and
    ``--process_id`` with JAX's meanings (``train.py:427-441``)."""
    parser.add_argument('--multihost', action='store_true',
                        help='one process per rank (torch.distributed); '
                             'the global batch is sharded over the ranks')
    parser.add_argument('--coordinator', type=str, default='',
                        help='with --multihost: host:port of rank 0 '
                             "(tcp://); unset: torchrun's env://")
    parser.add_argument('--num_processes', type=int, default=0,
                        help='with --coordinator: the number of ranks')
    parser.add_argument('--process_id', type=int, default=-1,
                        help='with --coordinator: this rank')


def choose_backend(device_type: str,
                   hosts: Sequence[Tuple[str, int]]) -> str:
    """The backend of ranks on ``device_type`` whose (host name, cards on
    that host) are ``hosts``, one per rank: 'nccl' where every rank has a
    card of its own (no host holds more ranks than cards), else 'gloo'
    (the CPU, or ranks sharing a card)."""
    ranks = Counter(name for name, _ in hosts)
    own = all(ranks[name] <= cards for name, cards in hosts)
    return 'nccl' if device_type == 'cuda' and own else 'gloo'


def local_rank(hosts: Sequence[Tuple[str, int]], rank: int) -> int:
    """Rank ``rank``'s place among the ranks of its host (``hosts`` as
    :func:`choose_backend` takes them)."""
    return sum(name == hosts[rank][0] for name, _ in hosts[:rank])


def host_layout(store, world: int, rank: int, cards: int
                ) -> List[Tuple[str, int]]:
    """Every rank's (host name, cards), in rank order, exchanged through
    the rendezvous ``store``: this rank's set, the others' awaited."""
    store.set(f'bihome/host/{rank}', f'{cards} {socket.gethostname()}')
    layout = []
    for r in range(world):
        count, name = store.get(f'bihome/host/{r}').decode().split(' ', 1)
        layout.append((name, int(count)))
    return layout


def init_from_args(args) -> torch.device:
    """The device of this process; with ``args.multihost`` the process
    group is started first (see the module docstring) and one line names
    the backend. Raises without CUDA unless ``args.device`` is 'cpu'."""
    device = resolve_device(args.device)
    if not args.multihost:
        return device
    if args.coordinator:
        if args.num_processes < 1 or args.process_id < 0:
            raise ValueError('--coordinator needs --num_processes and '
                             '--process_id')
        world, rank = args.num_processes, args.process_id
        init_method = f'tcp://{args.coordinator}'
    else:
        world = int(os.environ['WORLD_SIZE'])
        rank = int(os.environ['RANK'])
        init_method = 'env://'
    store, rank, world = next(dist.rendezvous(init_method, rank, world))
    cards = torch.cuda.device_count() if device.type == 'cuda' else 0
    hosts = host_layout(store, world, rank, cards)
    backend = choose_backend(device.type, hosts)
    if device.type == 'cuda':
        device = torch.device('cuda', local_rank(hosts, rank) % cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank)
    if rank == 0:
        shared = (' (ranks share a card: not a scaling run)'
                  if device.type == 'cuda' and backend == 'gloo' else '')
        print(f'Distributed: {world} ranks, backend {backend}, rank 0 on '
              f'{device}{shared}')
    return device


def shard_range(batch: int, world: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``rank``'s contiguous slice of a global batch;
    raises ValueError when ``world`` does not divide ``batch``
    (``trainer.py:159-160``)."""
    if batch % world:
        raise ValueError(f'batch {batch} % ranks {world} != 0')
    local = batch // world
    return rank * local, (rank + 1) * local


def shard_batch(x):
    """This rank's contiguous slice of a global batch (the leading axis)."""
    lo, hi = shard_range(x.shape[0], get_world_size(), get_rank())
    return x[lo:hi]


def _all_reduce(buf: Tensor, op=dist.ReduceOp.SUM) -> None:
    """In-place reduction over the ranks (SUM unless ``op``); gloo reduces
    a card's tensor through the host."""
    if buf.is_cuda and dist.get_backend() == 'gloo':
        host = buf.cpu()
        dist.all_reduce(host, op)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, op)


def min_over_ranks(t: Tensor) -> Tensor:
    """The elementwise least of ``t`` over the ranks (a new tensor)."""
    out = t.clone()
    if get_world_size() > 1:
        _all_reduce(out, dist.ReduceOp.MIN)
    return out


def sum_over_ranks(*tensors: Tensor) -> List[Tensor]:
    """Each tensor summed over the ranks (new tensors; one collective for
    all of them, in their promoted dtype); the tensors themselves in one
    process."""
    if get_world_size() == 1:
        return list(tensors)
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    _all_reduce(flat)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def gather_over_ranks(t: Tensor) -> Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along the
    leading axis in rank order, on ``t``'s device (one collective; gloo
    gathers a card's tensor through the host); ``t`` itself in one
    process."""
    world = get_world_size()
    if world == 1:
        return t
    src = t.contiguous()
    if src.is_cuda and dist.get_backend() == 'gloo':
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def all_reduce_grads(params: Sequence[torch.nn.Parameter],
                     scale: float) -> None:
    """Sum the gradients of ``params`` over the ranks in one collective,
    then multiply them by ``scale``. Parameters without a gradient (the
    same on every rank: the score CNN under the double-line loss) are
    left out. No-op in one process."""
    if get_world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat)
    flat.mul_(scale)
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()
