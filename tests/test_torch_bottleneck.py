"""The port's Bottleneck ResNets (``bihome_torch/models/resnet.py``:
resnet50/101/152, MODEL.HEAD.AUXILIARY_RESNET) and the block library's
``ResNet34DeconvBlock`` against the JAX package, float32, the JAX
weights carried across (``utils/aux_store``, ``models/weights``).

* ``ResNet('resnet50')`` cut at layers 1 and 2 and whole, ``resnet101`` at
  layer 1 and ``resnet152`` at layer 2, 1-channel stem, batch 2 of 32x32
  inputs (64x64 for the whole network), BN affines and statistics
  randomised: eval-mode output and input gradient, each within 1e-4 of its
  largest entry (the same convolutions summed in other orders); for the
  cut networks also the training-mode output and new running statistics
  (the whole network's layer4 normalises a handful of values a channel in
  training, where float32 rounding alone moves its output by 1e-3 even at
  64x64); the parameter
  count of the whole resnet50 (torchvision's 25,557,032 less the 2 * 49 *
  64 weights of two stem channels).
* A resnet50 extractor written by ``aux_store.save_aux_npz`` reads in
  JAX's ``load_aux_npz`` and gives JAX's ``ResNet`` the port's features;
  a whole JAX train state with a resnet50 extractor carries across with
  ``weights.state_dict_from_jax``; a torchvision-layout resnet50 (3-channel
  stem) grafts through ``torchvision_port`` and the reference checkpoint
  reader ('1.resnet.').
* The biHomE loss with a resnet50 extractor (layer1's 256 channels) in the
  port's PerceptualHead against JAX's head through the pass-through
  backbone of ``tests/test_torch_bihome_variants.py``, plain, through a
  projection head from the 256 channels, and with learned masks
  (MASK_KEYS): loss and metrics rtol 1e-4 (the loss terms ln1-ln3 also
  within 1e-4 of their summed magnitude), the gradients of the deltas
  (and masks) within 1e-3 of their largest entry (that file's limits).
* ``MODEL.HEAD.AUXILIARY_RESNET=resnet50`` trains through the port's train
  entry point on the CPU.
* ``ResNet34DeconvBlock`` against JAX's in eval and training mode: output,
  input and parameter gradients, new statistics, 1e-4 of the largest
  entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu.heads import assembled as jassembled
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_tpu.models import blocks as jblocks
from bihome_tpu.models.resnet import ResNet as JResNet
from bihome_tpu.training import losses as jlosses
from bihome_tpu.utils import aux_store as jaux
from bihome_torch import config as tconfig
from bihome_torch.heads import assembled as tassembled
from bihome_torch.heads.config import HeadConfig as THeadConfig
from bihome_torch.models import blocks as tblocks
from bihome_torch.models import backbones, torchvision_port, weights
from bihome_torch.models.resnet import ResNet
from bihome_torch.training import losses as tlosses
from bihome_torch.utils import aux_store
from tests import test_torch_bihome_variants as variants
from tests.test_torch_backbone import randomize_variables


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while this file runs: its CPU work is
    small, and the parallel test run's workers then do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [('resnet50', 1), ('resnet50', 2), ('resnet50', None),
         ('resnet101', 1), ('resnet152', 2)]
ZENG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'


def _close(got, want, name=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=name)


def _jax_resnet(arch, layer, x, seed=0):
    model = JResNet(arch=arch, output_layer=layer)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return model, randomize_variables(variables, np.random.RandomState(seed))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _out_nhwc(t):
    t = t.detach()
    return (t if t.dim() == 2 else t.permute(0, 2, 3, 1)).numpy()


@pytest.mark.parametrize('arch,layer', CASES)
def test_bottleneck_resnet_matches_jax(arch, layer):
    rs = np.random.RandomState(1)
    # The whole network at 64x64: at 32x32 its stem leaves 357 all-zero
    # max-pool windows (ties), and JAX's jitted input gradient stands 2e-2
    # from its own eager one, which the port's matches within 1.5e-6.
    side = 64 if layer is None else 32
    x = rs.randn(2, side, side, 1).astype(np.float32)
    jmodel, variables = _jax_resnet(arch, layer, x)
    model = ResNet(arch, output_layer=layer)
    state, dropped = aux_store.state_dict_from_aux(variables, 4)
    assert dropped == []
    weights.load_state_dict(model, state)

    def jfn(xj, cot):
        y = jmodel.apply(variables, xj, train=False)
        return jnp.sum(y * cot), y
    want_shape = jax.eval_shape(lambda: jmodel.apply(
        variables, jnp.asarray(x), train=False)).shape
    cot = rs.randn(*want_shape).astype(np.float32)
    gx, want = jax.jit(jax.grad(jfn, has_aux=True))(jnp.asarray(x),
                                                    jnp.asarray(cot))
    xt = _nchw(x).requires_grad_(True)
    got = model.eval()(xt)
    (got * (torch.from_numpy(cot) if got.dim() == 2
            else _nchw(cot))).sum().backward()
    _close(_out_nhwc(got), want, 'eval output')
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, 'input gradient')
    if layer is None:
        assert model.fc.in_features == 2048
        assert sum(p.numel() for p in model.parameters()) == (
            25_557_032 - 2 * 49 * 64)
        return
    want_train, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                       mutable=['batch_stats'])
    with torch.no_grad():
        got_train = model.train()(_nchw(x))
    _close(_out_nhwc(got_train), want_train, 'training output')
    new, _ = aux_store.state_dict_from_aux(
        {'batch_stats': mutated['batch_stats']}, 4)
    buffers = dict(model.named_buffers())
    for key, value in new.items():
        _close(buffers[key].numpy(), value.numpy(), key)


def test_saved_bottleneck_extractor_reads_in_jax(tmp_path):
    model = ResNet('resnet50', output_layer=2)
    backbones.init_weights(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_var'):
                buf.uniform_(0.5, 1.5)
            elif name.endswith('running_mean'):
                buf.normal_(0.0, 0.1)
    path = str(tmp_path / 'aux_r50.npz')
    aux_store.save_aux_npz(path, model.state_dict())
    loaded = jaux.load_aux_npz(path)
    assert sorted(loaded['params']['layer1_0']) == [
        'bn1', 'bn2', 'bn3', 'conv1', 'conv2', 'conv3', 'downsample_bn',
        'downsample_conv']
    x = np.random.RandomState(4).randn(2, 64, 64, 1).astype(np.float32)
    jmodel = JResNet(arch='resnet50', output_layer=2)
    pruned, dropped = jaux.prune_to_template(
        loaded, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    assert dropped == []
    want = jmodel.apply(pruned, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    _close(_out_nhwc(got), want)
    state, _ = aux_store.state_dict_from_aux(aux_store.load_aux_npz(path), 2)
    for key, value in state.items():
        torch.testing.assert_close(value, model.state_dict()[key], rtol=0,
                                   atol=0, msg=key)


def _resnet50_config():
    config = tconfig.load_config(ZENG)
    return tconfig.apply_overrides(config,
                                   ['MODEL.HEAD.AUXILIARY_RESNET=resnet50'])


def test_train_state_and_torchvision_layout_carry_a_resnet50_extractor():
    built = tconfig.build_model(_resnet50_config())
    model = built.model
    assert model.auxiliary_resnet.layer1[0].conv3.out_channels == 256
    x = np.zeros((1, 32, 32, 1), np.float32)
    _, aux = _jax_resnet('resnet50', 1, x, seed=2)
    own = model.state_dict()
    backbone = {c: {} for c in ('params', 'batch_stats')}
    state = weights.state_dict_from_jax({
        c: {'backbone': backbone[c], 'auxiliary_resnet': aux[c]}
        for c in ('params', 'batch_stats')})
    aux_keys = {k for k in own if k.startswith('auxiliary_resnet.')
                and not k.endswith('num_batches_tracked')}
    assert set(state) == aux_keys
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected
    assert not [k for k in missing if k.startswith('auxiliary_resnet.')
                and not k.endswith('num_batches_tracked')]
    # A torchvision resnet50 (3-channel stem, fc) grafts its stem summed
    # over RGB, as a file or as a reference checkpoint's '1.resnet.'.
    tv = ResNet('resnet50', output_layer=None, in_channels=3)
    backbones.init_weights(tv, torch.Generator().manual_seed(5))
    tv_state = tv.state_dict()
    sub = torchvision_port.port_torchvision_resnet(
        tv_state, include_fc=False, sum_rgb_stem=True)
    torchvision_port.graft(model.auxiliary_resnet, sub)
    torch.testing.assert_close(model.auxiliary_resnet.conv1.weight,
                               tv_state['conv1.weight'].sum(1, keepdim=True))
    torch.testing.assert_close(model.auxiliary_resnet.layer1[2].bn3.bias,
                               tv_state['layer1.2.bn3.bias'])
    ref = {f'0.{k}': v for k, v in model.backbone.state_dict().items()}
    ref.update({f'1.resnet.{k}': v.clone() * 2 for k, v in tv_state.items()
                if k.startswith('layer1.0.conv3')})
    loaded = torchvision_port.load_reference_checkpoint(model, ref,
                                                        'Rethinking')
    assert loaded == ['backbone', 'auxiliary_resnet']
    torch.testing.assert_close(model.auxiliary_resnet.layer1[0].conv3.weight,
                               tv_state['layer1.0.conv3.weight'] * 2)


# case -> (the variants test's case whose inputs and head it takes, extra
# MODEL.HEAD keys): the loss over the 256 channels, a projection head from
# them, and the learned masks pooled to the features.
R50_LOSS_CASES = {
    'l2-channel-aware': ('l2-channel-aware', {}),
    'projection head': ('l2-channel-aware',
                        {'WITH_PROJECTION_HEAD': [[256, 32]]}),
    'masks': ('masks', {}),
}


@pytest.mark.parametrize('case', sorted(R50_LOSS_CASES))
def test_bihome_loss_with_resnet50_extractor_matches_jax(case):
    """The double-line biHomE loss over 256-channel layer-1 features."""
    name, extra = R50_LOSS_CASES[case]
    head, backbone_cfg = variants._head(jconfig, name)
    head = dict(head, AUXILIARY_RESNET='resnet50', **extra)
    hcfg = JHeadConfig.from_yaml(head, backbone_cfg)
    jmodel = jassembled.AssembledModel(backbone=variants.JPass(), head=hcfg)
    data, inj = variants._inputs(name)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    feed = {**jdata, **{f'injected/{k}': jnp.asarray(v)
                        for k, v in inj.items()}}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(3), feed,
                                                train=False))
    filled = variants._filled(shapes, np.random.RandomState(3))
    variables = {c: dict(filled.get(c, {}), auxiliary_resnet=(
        randomize_variables(filled[c]['auxiliary_resnet'],
                            np.random.RandomState(6))))
        for c in ('params', 'batch_stats')}
    assert variables['params']['auxiliary_resnet']['layer1_0']['conv3'][
        'kernel'].shape == (1, 1, 64, 256)

    def loss_fn(d):
        out = jmodel.apply(variables, {**jdata, **{
            f'injected/{k}': v for k, v in d.items()}}, train=True,
            mutable=['batch_stats'])[0]
        return jlosses.compute_loss('biHomE', out), out['metrics']

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))({k: jnp.asarray(v) for k, v in inj.items()})

    model = tassembled.AssembledModel(variants.TPass(False),
                                      THeadConfig.from_yaml(
                                          variants._head(tconfig, name)[0]
                                          | {'AUXILIARY_RESNET': 'resnet50'}
                                          | extra, backbone_cfg))
    state = weights.state_dict_from_jax({
        c: dict(variables[c], backbone={}) for c in variables})
    weights.load_state_dict(model, state)
    model.train()
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in inj.items()}
    out = model({**{k: torch.from_numpy(v) for k, v in data.items()},
                 **{f'injected/{k}': v for k, v in leaves.items()}})
    loss = tlosses.compute_loss('biHomE', out)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-6)
    # The loss terms ln1-ln3 are sums of differences of feature distances:
    # each is held within 1e-4 of the terms' summed magnitude, as
    # tests/test_torch_ddp_step.py holds the loss (masks: ln2 is 1.77e-2
    # where l2 and l3 differ by 6e-6, and the two sides' ln2 read 3.0e-6
    # apart).
    terms = sum(abs(float(jmetrics[f'loss_comp/ln{i}'])) for i in (1, 2, 3))
    for key, value in jmetrics.items():
        atol = 1e-4 * terms if key.startswith('loss_comp/ln') else 1e-6
        np.testing.assert_allclose(float(out['metrics'][key]), float(value),
                                   rtol=1e-4, atol=atol, err_msg=key)
    keys = variants.KEYS if name == 'masks' else variants.KEYS[:2]
    for key in keys:
        want = np.asarray(jgrads[key])
        assert np.abs(want).max() > 0, key
        np.testing.assert_allclose(leaves[key].grad.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=key)


def test_resnet50_extractor_trains_through_the_cli(tmp_path):
    from bihome_torch import train
    result = train.main([
        '--config_file', ZENG, '--synthetic', '--steps', '1',
        '--batch_size', '2', '--epochs', '1', '--device', 'cpu',
        '--set', f'LOGGING.DIR={tmp_path}',
        '--set', 'MODEL.HEAD.AUXILIARY_RESNET=resnet50'])
    model = result['model']
    assert model.auxiliary_resnet.layer1[0].conv3.out_channels == 256
    assert bool(torch.isfinite(result['losses']).all())
    final = model.state_dict()
    assert all(torch.equal(final[k], result['initial_state'][k])
               for k in final if k.startswith('auxiliary_resnet.'))


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_resnet34_deconv_block_matches_jax(train):
    rs = np.random.RandomState(8)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    net = jblocks.ResNet34DeconvBlock()
    variables = randomize_variables(
        net.init(jax.random.PRNGKey(0), jnp.asarray(x)), rs)
    cot = rs.randn(2, 16, 16, 8).astype(np.float32)

    def jfn(xj, params):
        y, mut = net.apply({'params': params,
                            'batch_stats': variables['batch_stats']}, xj,
                           train=train, mutable=['batch_stats'])
        return jnp.sum(y * cot), (y, mut['batch_stats'])

    (gx, gp), (want, stats) = jax.grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables['params'])
    block = tblocks.ResNet34DeconvBlock(16)
    state = weights.block_state_dict(variables, weights._DECONV34)
    weights.load_state_dict(block, state)
    block.train(train)
    xt = _nchw(x).requires_grad_(True)
    got = block(xt)
    (got * _nchw(cot)).sum().backward()
    _close(_out_nhwc(got), want, 'output')
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, 'input gradient')
    params = dict(block.named_parameters())
    grads = weights.block_state_dict(
        {'params': gp, 'batch_stats': stats}, weights._DECONV34)
    for key, value in grads.items():
        if key.endswith(('running_mean', 'running_var')):
            _close(dict(block.named_buffers())[key].numpy(), value.numpy(),
                   key)
        else:
            _close(params[key].grad.numpy(), value.numpy(), key)
