"""Scalar logging (counterpart of ``bihome_tpu/training/metrics.py:19-75``):
one ``{"step": N, key: value}`` line per call in
``<LOGGING.DIR>/metrics.jsonl``, the same keys as the JAX trainer
(loss/train, g_norm/value, lr/value, mace/train, loss_comp/*, ...), and,
with the environment variable BIHOME_TENSORBOARD set (to anything but the
empty string), the same scalars as TensorBoard events in LOGGING.DIR
(``torch.utils.tensorboard.SummaryWriter``), as JAX writes them. Where
that writer cannot be imported or made, JAX drops the events silently;
the port drops them too and says so in one line on stderr.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import torch


def _tensorboard(log_dir: str):
    """A SummaryWriter on ``log_dir`` when BIHOME_TENSORBOARD asks for
    one, else None."""
    if not os.environ.get('BIHOME_TENSORBOARD'):
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir)
    except Exception as e:          # JAX's writer drops them the same way
        print(f'BIHOME_TENSORBOARD is set, but no TensorBoard writer: {e!r}'
              f'; writing metrics.jsonl only', file=sys.stderr)
        return None


class MetricsWriter:
    """Appends to ``<log_dir>/metrics.jsonl`` (and the TensorBoard events).
    Tensor values are moved to the host together, one device
    synchronisation per call."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')
        self._tb = _tensorboard(log_dir)

    def scalars(self, step: int, values: Dict) -> Dict[str, float]:
        keys = list(values)
        tensors = [torch.as_tensor(values[k], dtype=torch.float32)
                   for k in keys]
        dev = next((t.device for t in tensors if t.device.type == 'cuda'),
                   torch.device('cpu'))
        host = (torch.stack([t.to(dev) for t in tensors]).cpu()
                if tensors else torch.zeros(0))
        rec = {'step': int(step)}
        rec.update({k: float(v) for k, v in zip(keys, host.tolist())})
        self._jsonl.write(json.dumps(rec) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k in keys:
                self._tb.add_scalar(k, rec[k], int(step))
        return rec

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_writer(log_dir: str, rank: int):
    """The writer of rank ``rank``: a :class:`MetricsWriter` on rank 0, a
    :class:`NullWriter` elsewhere (nothing written)."""
    return MetricsWriter(log_dir) if rank == 0 else NullWriter()


class NullWriter:
    """The writer of every rank but 0 (``bihome_tpu/training/metrics.py:
    62-75``): the metrics are global, so rank 0 alone writes them."""

    def scalars(self, step: int, values: Dict) -> None:
        return None

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
