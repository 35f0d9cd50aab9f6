"""Port loss tail (bihome_torch.ops.fused_loss.triplet_double_line, a
``torch.autograd.Function`` with the hand-written backward) against the
JAX reference ``bihome_tpu.ops.fused_loss.triplet_double_line`` (an XLA
custom VJP), and the SOLVER.LOSS dispatch (training/losses.py) against
``bihome_tpu.training.losses.compute_loss``.

Every variant: margin 0.02 (hinge) and 'inf' (none), channel-aware and
channel-agnostic aggregation, ``second_scale`` (the margin*C quirk) on and
off, ``plain_grad`` on and off. One batch element's mask sums below 1, so
the clamp of the normaliser is live there. Forward values, the eight
metrics (which carry no gradient) and the four input cotangents for the
weighted sum 0.7*ln1 + 1.3*ln2: tolerance 1e-5 relative to each tensor's
largest entry (float32, sums in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.ops import fused_loss as jloss
from bihome_tpu.training import losses as jlosses
from bihome_torch.ops import fused_loss as tloss
from bihome_torch.training import losses as tlosses


def _inputs(seed, b=3, h=6, w=5, c=8):
    rs = np.random.RandomState(seed)
    fp_w = rs.randn(2 * b, h, w, c).astype(np.float32)
    f_plain = rs.randn(2 * b, h, w, c).astype(np.float32)
    w1 = rs.uniform(0.05, 1.0, (b, h, w)).astype(np.float32)
    w2 = rs.uniform(0.05, 1.0, (b, h, w)).astype(np.float32)
    w2[1] *= 0.5 / w2[1].sum()            # den below 1: the clamp is live
    return fp_w, f_plain, w1, w2


def _close(got, want, name):
    want = np.asarray(want)
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=0,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize('margin,agg,second,plain_grad', list(
    itertools.product([0.02, 'inf'], ['channel-aware', 'channel-agnostic'],
                      [True, False], [False, True])))
def test_triplet_double_line_matches_jax(margin, agg, second, plain_grad):
    args = _inputs(seed=len(str(margin)) + 2 * second + plain_grad)

    def jfn(*a):
        ln1, ln2, metrics = jloss.triplet_double_line(*a, margin, agg,
                                                      second, plain_grad)
        return 0.7 * ln1 + 1.3 * ln2, (ln1, ln2, metrics)

    jgrads, (jln1, jln2, jmetrics) = jax.grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(a) for a in args])

    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ln1, ln2, metrics = tloss.triplet_double_line(*targs, margin, agg,
                                                  second, plain_grad)
    _close(ln1.detach(), jln1, 'ln1')
    _close(ln2.detach(), jln2, 'ln2')
    assert len(metrics) == 8
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        assert not got.requires_grad
        _close(got, want, f'metric {i}')
    (0.7 * ln1 + 1.3 * ln2).backward()
    for name, t, want in zip(('d_fp', 'd_plain', 'd_w1', 'd_w2'), targs,
                             jgrads):
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        if name == 'd_plain' and not plain_grad:
            assert t.grad is None and not np.asarray(want).any()
            continue
        _close(got, want, name)


@pytest.mark.parametrize('loss_name', ['MSELoss', 'L1Loss', 'SmoothL1Loss',
                                       'CosineDistance', 'biHomE'])
@pytest.mark.parametrize('ndim', [2, 4])
def test_compute_loss_matches_jax(loss_name, ndim):
    rs = np.random.RandomState(ndim)
    shape = (3, 8) if ndim == 2 else (2, 4, 5, 6)
    gt = rs.randn(*shape).astype(np.float32)
    out = (gt + rs.randn(*shape) * 1.5).astype(np.float32)
    scalar = np.float32(rs.randn())
    want = jlosses.compute_loss(loss_name, {
        'ground_truth': jnp.asarray(gt), 'network_output': jnp.asarray(out),
        'loss': jnp.asarray(scalar)})
    got = tlosses.compute_loss(loss_name, {
        'ground_truth': torch.from_numpy(gt),
        'network_output': torch.from_numpy(out),
        'loss': torch.tensor(scalar)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_compute_loss_rejects_unknown():
    with pytest.raises(ValueError, match='Do not know the loss'):
        tlosses.compute_loss('Hinge', {'loss': torch.zeros(())})
