"""Distributed helpers (counterpart of ``bihome_tpu/parallel/dist_util.py``;
ref: src/utils/dist_util.py:7-96), on ``torch.distributed``.

| reference / JAX            | here                                   |
|----------------------------|----------------------------------------|
| get_world_size()           | ``dist.get_world_size()``              |
| get_rank()                 | ``dist.get_rank()``                    |
| is_main_process()          | rank 0                                 |
| synchronize() barrier      | ``dist.barrier()``                     |
| all_gather(data)           | ``dist.all_gather_object`` (host data) |

Each is a no-op (one process, rank 0) when ``torch.distributed`` is not
initialised, as the reference's are. ``all_gather`` gathers host data
(numpy arrays, CPU tensors, numbers) by pickling: gloo has no all_gather
of CUDA tensors.
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across the ranks (no-op in one process)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """``data`` of every rank, in rank order (``[data]`` in one process)."""
    if get_world_size() == 1:
        return [data]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out
