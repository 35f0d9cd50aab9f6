"""Port auxiliary extractor (bihome_torch.models.resnet, loaded by
bihome_torch.utils.aux_store) against the JAX reference
``bihome_tpu.models.resnet.ResNet(arch='resnet34', output_layer=1)``
loaded by ``bihome_tpu.utils.aux_store``, both from the committed
``aux_clfbh.npz``, in eval mode (the frozen extractor's mode in training).

Forward on a batch of 2 grayscale 32x32 patches and the input gradient
for a random cotangent: each within 1e-4 of its largest entry (float32,
the same convolutions in different orders). Also: the npz maps onto
every key of the port's extractor, a deeper npz is pruned to the model's
depth, and a whole JAX train state (backbone plus extractor, params and
batch statistics) carries across with ``weights.state_dict_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bihome_tpu.models.resnet import ResNet as JResNet
from bihome_tpu.utils import aux_store as jaux
from bihome_torch.models import weights
from bihome_torch.models.resnet import ResNet
from bihome_torch.utils import aux_store

NPZ = 'aux_clfbh.npz'


def _port_extractor():
    model = ResNet('resnet34', output_layer=1)
    state, dropped = aux_store.state_dict_from_aux(
        aux_store.load_aux_npz(NPZ), 1)
    assert dropped == []
    weights.load_state_dict(model, state)
    return model.eval()


def test_aux_extractor_matches_jax_forward_and_input_grad():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 32, 32, 1).astype(np.float32)
    cot = rs.randn(2, 8, 8, 64).astype(np.float32)
    variables = jaux.load_aux_npz(NPZ)
    jmodel = JResNet(arch='resnet34', output_layer=1)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pruned, dropped = jaux.prune_to_template(variables, template)
    assert dropped == []

    def jloss(xj):
        f = jmodel.apply(pruned, xj, train=False)
        return jnp.sum(f * cot), f

    jgrad, want = jax.grad(jloss, has_aux=True)(jnp.asarray(x))

    model = _port_extractor()
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    xt.requires_grad_(True)
    got = model(xt)
    (got * torch.from_numpy(np.ascontiguousarray(
        cot.transpose(0, 3, 1, 2)))).sum().backward()
    for name, a, b in (('features', got.detach().permute(0, 2, 3, 1).numpy(),
                        np.asarray(want)),
                       ('input grad', xt.grad.permute(0, 2, 3, 1).numpy(),
                        np.asarray(jgrad))):
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_deeper_npz_is_pruned_to_the_model_depth():
    tree = aux_store.load_aux_npz(NPZ)
    deeper = {c: dict(tree[c]) for c in tree}
    deeper['params']['layer2_0'] = tree['params']['layer1_0']
    deeper['batch_stats']['layer2_0'] = tree['batch_stats']['layer1_0']
    state, dropped = aux_store.state_dict_from_aux(deeper, 1)
    assert dropped == ['layer2_0']
    weights.load_state_dict(ResNet('resnet34', output_layer=1), state)


def test_whole_train_state_carries_across():
    """A JAX AssembledModel tree {'params': {'backbone', 'auxiliary_resnet'},
    'batch_stats': {...}} maps onto every key of the port's model."""
    from bihome_torch.config import build_model, load_config
    from tests.test_torch_backbone import jax_backbone, randomize_variables

    rs = np.random.RandomState(1)
    data = {k: jnp.zeros((1, 32, 32, 1)) for k in ('patch_1', 'patch_2')}
    backbone = randomize_variables(
        jax_backbone().init(jax.random.PRNGKey(0), data), rs)
    aux = aux_store.load_aux_npz(NPZ)
    variables = {c: {'backbone': backbone[c], 'auxiliary_resnet': aux[c]}
                 for c in ('params', 'batch_stats')}
    state = weights.state_dict_from_jax(variables)
    model = build_model(load_config(
        'config/s-coco/zeng-bihome-lr-1e-3.yaml')).model
    weights.load_state_dict(model, state)
    for key in ('backbone.layer8.1.running_mean',
                'backbone.layer8.1.running_var',
                'auxiliary_resnet.layer1.2.bn2.running_var',
                'auxiliary_resnet.conv1.weight'):
        assert key in state
    np.testing.assert_array_equal(
        model.backbone.layer8[1].running_var.numpy(),
        backbone['batch_stats']['layer8']['bn_var'])
    np.testing.assert_array_equal(
        model.auxiliary_resnet.conv1.weight.numpy(),
        np.transpose(aux['params']['conv1']['kernel'], (3, 2, 0, 1)))
