"""One step of the port's pretext training (``bihome_torch.pretrain_aux``)
against JAX's loss composed from ``tools/pretrain_aux.py``'s own functions
(``tests/torch_pretrain_oracle.py``), the same weights carried across and
the same injected draws, float32: rotnet, grad, gradpi and gradpds here,
the contrastive pretexts in ``test_torch_pretrain_step_cl.py``. Also the
extractor at bf16 against flax's at bf16.

Small size: patches 64x64 from 128x128 pool images, batch 2, the BN
affines and statistics randomised. Tolerances (float32, the same formulas
in other summation orders): the batch within 1e-4 of its largest entry
(the pair warp and the PDS distortion's HSV round trip); the loss rtol
1e-4; the accuracy figure within 1e-4 (rotnet's exactly); each gradient
tensor 1e-3 relative L2; the new BN statistics rtol 1e-4 and 1e-5 of
their largest entry. At bf16: the features and the input gradient of the
extractor, in eval and in training mode, within BF16_LIMITS relative L2
of flax's at bf16, as ``tests/test_torch_bf16_modules.py`` holds the
blocks, which the port at float32 must miss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_torch import pretrain_aux
from bihome_torch.training.train_state import Optimizer
from tests import torch_pretrain_oracle as oracle
from tests.test_torch_bf16_head import rel_l2


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while this file runs: its CPU work is
    small, and the parallel test run's workers then do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BATCH_ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_L2 = 1e-3


# The seed of each pretext's weights and draws: it must put no ReLU input
# within float32 rounding of its kink, where the two sides take different
# subgradients (``tests/test_torch_resnet34.py``). rotnet's whole resnet34
# with seed 1 reads 8.6e-2 in one tensor, with 0 and 2-5 at most 1.4e-5.
SEED = 0


def step_readings(p, seed=SEED):
    """The step on both sides: (port loss, acc, grads, stats; JAX's)."""
    d, keys = oracle.draws(p, seed)
    jbatch = oracle.jax_batch(p, d, keys)
    jmodel, variables = oracle.jax_model(p)
    jloss, jacc, jgrads, jstats = oracle.jax_step(p, jmodel, variables,
                                                  jbatch)
    model = oracle.port_model(p, variables)
    batch = pretrain_aux.make_batch(p, torch.from_numpy(oracle.pool()),
                                    oracle.port_draws(p, d, keys))
    assert set(batch) == set(jbatch)
    for k, want in jbatch.items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            batch[k].numpy(), want, rtol=0,
            atol=BATCH_ATOL * max(1.0, np.abs(want).max()), err_msg=k)
    # The step itself on JAX's batch: the photometric distortion's HSV
    # round trip leaves ~1e-5 in gradpdscl's inputs, which its stem's
    # gradient amplifies to 2.6e-3 relative L2 (3.8e-6 on one batch).
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    before = {n: t.clone() for n, t in model.named_parameters()}
    loss, acc = pretrain_aux.train_step(
        p, model, Optimizer(model.parameters(), lr=1e-3), batch)
    grads = {n: t.grad.numpy() for n, t in model.named_parameters()}
    assert all(not torch.equal(t, before[n])
               for n, t in model.named_parameters())
    stats = {n: b.numpy() for n, b in model.named_buffers()
             if n.endswith(('running_mean', 'running_var'))}
    return ((float(loss), float(acc), grads, stats),
            (float(jloss), float(jacc),
             oracle.as_port_names(jgrads, 'params'),
             oracle.as_port_names(jstats, 'batch_stats')))


def check_step(p, seed=SEED):
    (loss, acc, grads, stats), (jloss, jacc, jgrads, jstats) = (
        step_readings(p, seed))
    print(f'{p.name}: loss {loss:.7f} vs JAX {jloss:.7f}, acc {acc:.6f} vs '
          f'{jacc:.6f}')
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    assert abs(acc - jacc) <= (0.0 if p.name == 'rotnet' else 1e-4)
    assert set(grads) == set(jgrads)
    worst = max((rel_l2(grads[n], jgrads[n]), n) for n in jgrads)
    print(f'{p.name}: worst gradient {worst}')
    assert worst[0] <= GRAD_L2, worst
    assert set(stats) == set(jstats)
    for n, want in jstats.items():
        np.testing.assert_allclose(stats[n], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(), err_msg=n)


@pytest.mark.parametrize('name', ['rotnet', 'grad', 'gradpi', 'gradpds'])
def test_pretext_step_matches_jax(name):
    check_step(oracle.pretext(name))


# (features, input gradient) limits of the bf16 extractor against flax's
# at bf16, by mode. This test's readings (CPU): eval 8.4e-4 and 1.09e-2,
# the port at float32 5.03e-3 and 0.133; training (batch statistics)
# 4.87e-3 and 6.56e-2, float32 9.20e-3 and 0.167.
BF16_LIMITS = {'eval': (2.5e-3, 5e-2), 'train': (7e-3, 0.1)}


@pytest.mark.parametrize('mode', sorted(BF16_LIMITS))
def test_extractor_bf16_matches_flax_bf16(mode):
    train = mode == 'train'
    p = oracle.pretext('grad')
    jmodel, variables = oracle.jax_model(p, jnp.bfloat16)
    rs = np.random.RandomState(9)
    x = rs.randn(2, oracle.PS, oracle.PS, 1).astype(np.float32)
    cot = rs.randn(2, oracle.PS // 4, oracle.PS // 4, 64).astype(np.float32)

    def jfn(xj):
        y, _ = jmodel.apply(variables, xj, train=train,
                            mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * cot), y

    gx, want = jax.grad(jfn, has_aux=True)(jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    readings = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = oracle.port_model(p, variables, dtype).train(train)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        xt.requires_grad_(True)
        got = model(xt)
        assert got.dtype == dtype
        (got.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum(
            ).backward()
        readings[dtype] = (
            rel_l2(got.detach().float().permute(0, 2, 3, 1).numpy(),
                   np.asarray(want, np.float32)),
            rel_l2(xt.grad.permute(0, 2, 3, 1).numpy(),
                   np.asarray(gx, np.float32)))
    print(f'extractor against flax at bf16, {mode} (features, input '
          f'gradient): {readings}')
    limits = BF16_LIMITS[mode]
    assert all(r <= lim for r, lim in zip(readings[torch.bfloat16], limits))
    assert all(r > lim for r, lim in zip(readings[torch.float32], limits))
