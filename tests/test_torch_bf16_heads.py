"""Each head of the configs that run at bfloat16 since the wide PF-head
kernels, from its input at bf16, against the JAX package's head at bf16:
detone-biHomE and zhang-biHomE (the PerceptualHead on the regressor's
deltas: the biHomE loss, ``_triplet_resnet_loss``), S-COCO nguyen-orig
(the PhotometricHead, L1), zeng-orig (the NoOp 'all_points' head,
SmoothL1 on the field) and CLEVR-Change (the TripletHead on whole
non-square renders).

The head's input (the backbone's outputs, bf16 as the bf16 backbone
returns them) and the pair data are handed to both sides, as
tests/test_torch_bf16_step.py hands them the PF head's input: the JAX
side runs only the head (``AssembledModel._*_forward`` through
``apply(method=...)``), the port its counterpart, in training mode.
Inputs: 32x32 patches (24x32 renders for CLEVR), batch 2, the frozen
extractor from ``aux_clfbh.npz``, CLEVR's feature extractor seeded.

JAX's side is compiled with XLA's 'excess precision' off: on by default,
XLA's CPU backend keeps a fusion's bf16 intermediates in float32, and JAX
at bf16 then stands as far from the port as from JAX at float32 (1.7e-2
to 1.9e-2 of the biHomE loss).

Limits. The heads with a bf16 extractor (biHomE: the frozen one;
Triplet: the backbone's feature extractor, re-run on the warped patches)
round: there the port must stand within half of JAX float32's distance
from JAX bf16, on the loss (relative) and on the gradients of the head's
inputs (relative L2 over all). Readings: port 2.3e-6 to 1.3e-4 on the
loss, 1.2e-3 to 2.2e-3 on the gradients; JAX float32 4.5e-4 to 0.13 and
1.3e-2 to 6.0e-2. The NoOp and Photometric heads round nowhere of their
own at bf16 (their sums and warps are float32 on the bf16 values): both
within 1e-5 (readings 3.1e-7 and 6.9e-8 on the loss, gradients equal).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu.data import synthetic as jsyn
from bihome_tpu.models import backbones as jbb
from bihome_tpu.training import losses as jlosses
from bihome_tpu.utils import aux_store as jaux
from bihome_torch import config as tconfig
from bihome_torch.models import weights
from bihome_torch.training import losses as tlosses
from bihome_torch.utils import aux_store
from tests.test_torch_backbone import randomize_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
B, PS = 2, 32
CLEVR_HW = (24, 32)

CASES = {
    'pds-detone-bihome': 'config/pds-coco/detone-bihome-lr-5e-3.yaml',
    'pds-zhang-bihome': 'config/pds-coco/zhang-bihome-lr-1e-2.yaml',
    's-coco-nguyen-orig': 'config/s-coco/nguyen-orig-lr-5e-3.yaml',
    'pds-zeng-orig': 'config/pds-coco/zeng-orig-lr-1e-3.yaml',
    'clevr-change': 'config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml'}
JAX_HEADS = {
    'PerceptualHead': lambda m, d, t: m._perceptual_forward(d, t),
    'PhotometricHead': lambda m, d, t: m._photometric_forward(d),
    'NoOpHead': lambda m, d, t: m._noop_forward(d),
    'TripletHead': lambda m, d, t: m._triplet_head_forward(d, t)}


def _config(module, path, dtype):
    config = module.load_config(os.path.join(REPO, path))
    config['MODEL']['DTYPE'] = dtype
    config['MODEL']['HEAD']['PATCH_SIZE'] = PS
    return config


def _bf16(a):
    """numpy float32 values rounded to bf16's."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _patches(rs, h, w):
    """Two standardized gray [B,h,w,1] crops of the synthetic generator's
    smooth textures (noise patches make every feature a rounding
    boundary's neighbour)."""
    pool = jsyn.make_image_pool(2 * B, 2 * h, 2 * w,
                                seed=int(rs.randint(1 << 16)))
    gray = (pool.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])
            )[..., None] / 255.0
    gray = (gray[:, h // 2:h // 2 + h, w // 2:w // 2 + w] - 0.443) / 0.129
    return {'patch_1': gray[:B], 'patch_2': gray[B:]}


def _inputs(name, rs):
    """(pair data, the head's inputs: name -> bf16-valued float32) of a
    case."""
    if name.endswith('bihome'):
        data = _patches(rs, PS, PS)
        inputs = {k: _bf16(rs.uniform(-4, 4, (B, 4, 2)))
                  for k in ('delta_hat_12', 'delta_hat_21')}
    elif name.endswith('nguyen-orig'):
        corners = np.array([[8, 6], [8 + PS, 6], [8 + PS, 6 + PS],
                            [8, 6 + PS]], np.float32)
        data = {'image_1': rs.randn(B, 48, 64, 1),
                'patch_2': rs.randn(B, PS, PS, 1),
                'corners': np.broadcast_to(corners, (B, 4, 2)),
                'delta': rs.uniform(-4, 4, (B, 4, 2))}
        inputs = {'delta_hat_12': _bf16(rs.uniform(-4, 4, (B, 4, 2)))}
    elif name.endswith('zeng-orig'):
        data = {'target': rs.uniform(-6, 6, (B, PS, PS, 2)),
                'delta': rs.uniform(-4, 4, (B, 4, 2))}
        inputs = {'pf_hat_12': _bf16(rs.uniform(-6, 6, (B, PS, PS, 2)))}
    else:
        h, w = CLEVR_HW
        data = _patches(rs, h, w)
        data.update({k: np.ones((B, h, w, 1)) for k in ('mask_1', 'mask_2')})
        inputs = {k: _bf16(np.abs(rs.randn(B, h, w, 1)))
                  for k in ('feature_1', 'feature_2')}
        inputs.update({k: _bf16(rs.uniform(-4, 4, (B, 4, 2)))
                       for k in ('delta_hat_12', 'delta_hat_21')})
    return ({k: np.asarray(v, np.float32) for k, v in data.items()},
            inputs)


def _variables(name, rs):
    """The head's own weights: the frozen extractor of the PerceptualHead
    (aux_clfbh.npz); the ContentAware backbone of the TripletHead (whose
    feature extractor the head re-runs), seeded."""
    if name.endswith('bihome'):
        aux = jaux.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz'))
        return {c: {'auxiliary_resnet': aux[c]}
                for c in ('params', 'batch_stats')}
    if name == 'clevr-change':
        net = jbb.ContentAwareBackbone(
            target_keys=('delta_hat_12', 'delta_hat_21'),
            variant='doubleline', fix_mask=True)
        patches = {k: jnp.zeros((B, *CLEVR_HW, 1)) for k in ('patch_1',
                                                           'patch_2')}
        variables = randomize_variables(
            net.init(jax.random.PRNGKey(0), patches), rs)
        return {c: {'backbone': variables[c]}
                for c in ('params', 'batch_stats')}
    return {'params': {}}


def _jax_head(name, dtype, variables, data, inputs):
    """(loss, gradients of the head's inputs) of JAX's head at
    ``dtype``; the inputs in ``dtype``."""
    built = jconfig.build_model(_config(jconfig, CASES[name], dtype))
    head = JAX_HEADS[built.head_cfg.name]
    jdata = {k: jnp.asarray(v) for k, v in data.items()}

    def loss_fn(inp):
        out, _ = built.model.apply(variables, {**jdata, **inp}, True,
                                   method=head, mutable=['batch_stats'])
        return jlosses.compute_loss(built.loss_name, out)

    jinp = {k: jnp.asarray(v).astype(dtype) for k, v in inputs.items()}
    # Compiled whole, XLA's CPU backend keeps bf16 intermediates of a
    # fusion in float32 ('excess precision'); the head's bf16 rounding
    # points stand only with it off.
    step = jax.jit(jax.value_and_grad(loss_fn)).lower(jinp).compile(
        {'xla_allow_excess_precision': False})
    loss, grads = step(jinp)
    return float(loss), {k: np.asarray(g, np.float64)
                         for k, g in grads.items()}


def _port_head(name, variables, data, inputs):
    """The same on the port's head at bf16, the inputs bf16 leaves."""
    built = tconfig.build_model(_config(tconfig, CASES[name], 'float32'),
                                dtype='bfloat16')
    model = built.model.train()
    if name.endswith('bihome'):
        state, _ = aux_store.state_dict_from_aux(
            aux_store.load_aux_npz(os.path.join(REPO, 'aux_clfbh.npz')),
            built.head_cfg.auxiliary_resnet_output_layer)
        weights.load_state_dict(model.auxiliary_resnet, state)
    elif name == 'clevr-change':
        weights.load_state_dict(model, weights.state_dict_from_jax(
            {c: {k: jax.tree_util.tree_map(np.asarray, v)
                 for k, v in variables[c].items()} for c in variables}))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    tinp = {k: torch.from_numpy(v).to(BF16).requires_grad_(True)
            for k, v in inputs.items()}
    merged = {**tdata, **tinp}
    cfg = built.head_cfg
    if cfg.name == 'PerceptualHead':
        out = model.bihome_loss(tdata, *(merged[k]
                                         for k in cfg.delta_hat_keys))
    elif cfg.name == 'PhotometricHead':
        out = model.photometric_head(merged)
    elif cfg.name == 'NoOpHead':
        out = model.noop_head(merged)
    else:
        out = model.triplet_head(merged)
    loss = tlosses.compute_loss(built.loss_name, out)
    loss.backward()
    assert all(t.grad.dtype == BF16 for t in tinp.values())
    return float(loss.detach()), {k: t.grad.double().numpy() for k, t in tinp.items()}


def _errors(got, want):
    """(relative loss error, the gradients' relative L2 over all inputs)."""
    flat = np.concatenate([got[1][k].ravel() for k in sorted(want[1])])
    ref = np.concatenate([want[1][k].ravel() for k in sorted(want[1])])
    return (abs(got[0] - want[0]) / abs(want[0]),
            float(np.linalg.norm(flat - ref) / np.linalg.norm(ref)))


@pytest.mark.parametrize('name', sorted(CASES))
def test_head_bf16_from_its_input_sits_with_jax_bf16(name):
    rs = np.random.RandomState(sorted(CASES).index(name) + 30)
    data, inputs = _inputs(name, rs)
    variables = _variables(name, rs)
    jax16 = _jax_head(name, 'bfloat16', variables, data, inputs)
    jax32 = _jax_head(name, 'float32', variables, data, inputs)
    port = _port_head(name, variables, data, inputs)
    assert np.isfinite(port[0]) and port[0] != 0
    (loss_err, l2), (loss_err32, l2_32) = (_errors(port, jax16),
                                           _errors(jax32, jax16))
    print(f'{name} from the head\'s input, against JAX bf16: port bf16 loss '
          f'{loss_err:.2e}, gradients {l2:.2e}; JAX f32 {loss_err32:.2e}, '
          f'{l2_32:.2e}')
    if name.endswith(('bihome', 'clevr-change')):
        assert loss_err <= 0.5 * loss_err32 and l2 <= 0.5 * l2_32
    else:
        assert loss_err <= 1e-5 and l2 <= 1e-5
