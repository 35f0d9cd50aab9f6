"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each a gap that a sound run keeps small.

Training (three steps from the same weights, pool and draws):

* ``loss_gap``: the largest over the steps of |loss - reference loss| /
  |reference loss|;
* ``grad_gap``: the worst leaf's |norm of the program's first gradient
  (read from Adam's first moment after one step, exp_avg / (1 - beta1)) -
  the reference's norm|, over the larger of the reference leaf's norm and
  the median leaf's;
* ``change_gap``: the same for the norm of each leaf's change over the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (below that a leaf moves under Adam by
  round-off alone).

Serving: ``delta_gap_px``, the largest |delta_hat - the reference's| in
pixels over a sample of the window's calls.
"""

from __future__ import annotations

import statistics
from typing import Dict, Mapping, Sequence

DEAD_LEAF = 1e-3


def _leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
              leaves: Sequence[str]) -> float:
    if not leaves:
        raise ValueError('no leaves to compare')
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
               for n in leaves)


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``loss`` [per step], ``grad_norm``
    and ``change_norm`` {leaf: norm}."""
    if len(prog['loss']) != len(ref['loss']):
        raise ValueError('the program and the reference ran different steps')
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog['loss'], ref['loss'])]
    leaves = sorted(ref['grad_norm'])
    med = statistics.median(ref['grad_norm'][n] for n in leaves)
    live = [n for n in leaves if ref['grad_norm'][n] >= DEAD_LEAF * med]
    return {'loss_gap': max(gaps),
            'first_loss_gap': gaps[0],
            'grad_gap': _leaf_gap(prog['grad_norm'], ref['grad_norm'],
                                  leaves),
            'change_gap': _leaf_gap(prog['change_norm'], ref['change_norm'],
                                    live)}


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each limited number beside its limit; a number missing, not finite
    or over its limit makes the run not correct."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, float('nan'))
        out[name] = {'value': value, 'limit': limit}
    return out


def passed(judged: Mapping[str, Mapping[str, float]]) -> bool:
    return all(v['value'] <= v['limit'] for v in judged.values())
