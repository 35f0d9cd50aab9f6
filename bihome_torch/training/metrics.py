"""Scalar logging as JSONL (counterpart of
``bihome_tpu/training/metrics.py:19-59``): one ``{"step": N, key: value}``
line per call in ``<LOGGING.DIR>/metrics.jsonl``, the same keys as the JAX
trainer (loss/train, g_norm/value, lr/value, mace/train, loss_comp/*, ...).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch


class MetricsWriter:
    """Appends to ``<log_dir>/metrics.jsonl``. Tensor values are moved to
    the host together, one device synchronisation per call."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')

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
        return rec

    def close(self) -> None:
        self._jsonl.close()


class NullWriter:
    """The writer of every rank but 0 (``bihome_tpu/training/metrics.py:
    62-75``): the metrics are global, so rank 0 alone writes them."""

    def scalars(self, step: int, values: Dict) -> None:
        return None

    def close(self) -> None:
        pass
