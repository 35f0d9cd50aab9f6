"""Port optimizer (bihome_torch.training.train_state) against the optax
chain of ``bihome_tpu.training.train_state.make_optimizer``: global-norm
clip, weight decay into the gradient, Adam (eps 1e-8), per-step
MultiStepLR, frozen ``auxiliary_resnet`` parameters untouched.

Six updates with milestones at 2 and 4, so the learning rate is read at
each milestone's k-1, k and k+1; the gradients' norm is above the clip
threshold on some steps and below it on others. Parameters after every
update: tolerance 1e-6 relative (float32 Adam, the same formula in
another order); the learning rates to float32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import optax
import torch

from bihome_tpu.training import train_state as jts
from bihome_torch.config import solver_kwargs
from bihome_torch.training import train_state as tts

KW = dict(lr=1e-2, milestones=[2, 4], decay=0.1, beta1=0.9, beta2=0.999,
          weight_decay=1e-2, gradient_clip=2.0)


def test_optimizer_matches_optax_chain():
    rs = np.random.RandomState(0)
    params = {'backbone': {'w': rs.randn(3, 4).astype(np.float32),
                           'b': rs.randn(4).astype(np.float32)},
              'auxiliary_resnet': {'k': rs.randn(5).astype(np.float32)}}
    tx, schedule = jts.make_optimizer(**KW)
    jparams = {k: {n: jnp.asarray(v) for n, v in d.items()}
               for k, d in params.items()}
    opt_state = tx.init(jparams)

    tparams = {k: {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for n, v in d.items()} for k, d in params.items()}
    trainable = list(tparams['backbone'].values())
    opt = tts.Optimizer(trainable, **KW)
    frozen_before = tparams['auxiliary_resnet']['k'].detach().clone()

    scales = [3.0, 0.1, 2.0, 0.05, 1.0, 4.0]
    norms = []
    for k, scale in enumerate(scales):
        grads = {key: {n: (rs.randn(*v.shape) * scale).astype(np.float32)
                       for n, v in d.items()} for key, d in params.items()}
        jgrads = {key: {n: jnp.asarray(v) for n, v in d.items()}
                  for key, d in grads.items()}
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in tparams['backbone'].items():
            p.grad = torch.from_numpy(grads['backbone'][n])
        norms.append(float(opt.global_norm()))
        lr = opt.step()
        np.testing.assert_allclose(lr, float(schedule(k)), rtol=1e-6)
        for n, p in tparams['backbone'].items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams['backbone'][n]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f'step {k} {n}')
    assert min(norms) < KW['gradient_clip'] < max(norms)
    assert [opt.schedule(k) for k in (1, 2, 3)] == [1e-2, 1e-2 * 0.1,
                                                    1e-2 * 0.1]
    np.testing.assert_array_equal(np.asarray(jparams['auxiliary_resnet']['k']),
                                  params['auxiliary_resnet']['k'])
    assert torch.equal(tparams['auxiliary_resnet']['k'], frozen_before)


def test_solver_kwargs_reads_the_reference_solver():
    config = {'SOLVER': {'OPTIMIZER': 'Adam', 'LR': 0.001,
                         'MILESTONES': [30000], 'LR_DECAY': 0.1,
                         'MOMENTUM_1': 0.9, 'MOMENTUM_2': 0.999}}
    assert solver_kwargs(config) == dict(
        lr=0.001, milestones=[30000], decay=0.1, beta1=0.9, beta2=0.999,
        weight_decay=0.0, gradient_clip=-1.0)
