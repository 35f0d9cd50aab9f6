"""Port Rethinking backbone (bihome_torch.models) against the JAX reference
(bihome_tpu.models.backbones.RethinkingBackbone), with the JAX weights
carried across by ``weights.state_dict_from_jax``.

Small size: DoubleLine, batch 2, 32x32 patches (the widths are fixed by the
architecture). BN statistics and affines are randomized so eval-mode parity
is a real test. Forward tolerance atol 2e-3, rtol 1e-3, as for the
reference-checkpoint import (tests/test_checkpoint_port.py): float32 on
both sides, the JAX side runs its fused deconv reparameterisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models import backbones as jbb
from bihome_tpu.models import torch_port
from bihome_torch.models import backbones as tbb
from bihome_torch.models import weights

KEYS = ('pf_hat_12', 'pf_hat_21')


def randomize_variables(variables, rs):
    """numpy copy of a flax Rethinking tree with random BN statistics,
    BN affines and conv biases."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, 'items'):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k in ('mean', 'bn_mean'):
                v = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif k in ('var', 'bn_var'):
                v = (rs.rand(*v.shape) * 0.5 + 0.75).astype(np.float32)
            elif k in ('scale', 'bn_scale'):
                v = (1.0 + 0.1 * rs.randn(*v.shape)).astype(np.float32)
            elif 'bias' in k:
                v = (0.1 * rs.randn(*v.shape)).astype(np.float32)
            out[k] = v
        return out
    return walk(variables)


def jax_backbone():
    return jbb.RethinkingBackbone(patch_keys=('patch_1', 'patch_2'),
                                  target_keys=KEYS, variant='doubleline')


def torch_backbone(variables):
    model = tbb.RethinkingBackbone(target_keys=KEYS, variant='doubleline')
    weights.load_state_dict(model, weights.state_dict_from_jax(variables))
    return model.eval()


@pytest.fixture(scope='module')
def reference():
    rs = np.random.RandomState(0)
    data = {k: rs.randn(2, 32, 32, 1).astype(np.float32)
            for k in ('patch_1', 'patch_2')}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = randomize_variables(
        jax_backbone().init(jax.random.PRNGKey(0), jdata), rs)
    out = jax_backbone().apply(variables, jdata, train=False)
    return variables, data, {k: np.asarray(v) for k, v in out.items()}


def test_weight_round_trip_is_exact(reference):
    variables, _, _ = reference
    model = torch_backbone(variables)
    port_keys = {k for k in model.state_dict()
                 if not k.endswith('num_batches_tracked')}
    assert set(weights.state_dict_from_jax(variables)) == port_keys
    back = torch_port.port_rethinking_full(
        {k: v.numpy() for k, v in model.state_dict().items()})

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v
    for coll in ('params', 'batch_stats'):
        want = dict(leaves(variables[coll]))
        got = dict(leaves(back[coll]))
        assert got.keys() == want.keys(), coll
        for path, v in want.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def test_doubleline_eval_forward_matches_jax(reference):
    variables, data, want = reference
    model = torch_backbone(variables)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()})
    for key in KEYS:
        assert got[key].shape == want[key].shape == (2, 32, 32, 2)
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-3,
                                   rtol=1e-3, err_msg=key)


def test_pf_head_refuses_training_mode():
    head = tbb.PFHead(16, 128, 2)
    with pytest.raises(NotImplementedError, match='not ported yet'):
        head(torch.zeros(1, 16, 4, 4))
