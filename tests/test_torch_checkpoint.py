"""The port's checkpoints, warm starts and torchvision grafts.

* ``Optimizer.load_state_dict``: the Adam moments and the MultiStepLR
  position come back, on the parameters' device; a state that does not
  fit raises and changes nothing. Tolerance: exact (the same updates).
* ``CheckPointer`` / ``resolve_checkpoint_dir``: only ``model_NNNNNN.pth``
  files count; RESTART_LEARNING_RATE and a changed trainable set.
* ``load_pretrained_params`` copies and skips the tensors that JAX's
  ``_merge_matching`` (``checkpoint.py:84-103``) copies and skips on the
  same trees (built from the port's tensors by JAX's own converters).
* The torchvision grafts equal JAX's ``torch_port`` rules composed with
  ``weights.state_dict_from_jax``, exactly, in the Rethinking encoder,
  the ResNet34 and ContentAware regressors and the extractor.
"""

import copy
import os

import numpy as np
import pytest
import torch

from bihome_torch import config as tconfig
from bihome_torch import train
from bihome_torch.models import backbones, weights
from bihome_torch.models.resnet import ResNet
from bihome_torch.training import checkpoint
from bihome_torch.training.train_state import Optimizer
from bihome_torch.utils import aux_store
from tests.test_torch_host_data import cpu_test_env  # noqa: F401

pytestmark = pytest.mark.usefixtures('cpu_test_env')

ZENG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'
ZENG_ORIG = 'config/pds-coco/zeng-orig-lr-1e-3.yaml'


def _built(path, sets=(), seed=0):
    config = tconfig.apply_overrides(tconfig.load_config(path), list(sets))
    built = tconfig.build_model(config)
    gen = torch.Generator().manual_seed(seed)
    backbones.init_weights(built.model.backbone, gen)
    if built.model.auxiliary_resnet is not None:
        backbones.init_weights(built.model.auxiliary_resnet, gen)
    return built


def _randomize_bn(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.normal_(1, 0.1, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)


# ------------------------------------------------------------- optimizer

def _net(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))


def _step(net, opt, k):
    opt.zero_grad()
    x = torch.arange(6.0).reshape(2, 3) + k
    net(x).square().sum().backward()
    return opt.step()


def test_optimizer_state_round_trip_continues_exactly():
    kw = dict(lr=1e-2, milestones=[3], decay=0.5, weight_decay=1e-4,
              gradient_clip=5.0)
    a = _net()
    opt_a = Optimizer(a.parameters(), **kw)
    for k in range(3):
        _step(a, opt_a, k)
    b = copy.deepcopy(a)
    opt_b = Optimizer(b.parameters(), **kw)
    opt_b.load_state_dict(opt_a.state_dict())
    assert opt_b.count == 3
    for p in b.parameters():
        state = opt_b.adam.state[p]
        assert state['exp_avg'].device == p.device
    for k in (3, 4):
        assert _step(a, opt_a, k) == _step(b, opt_b, k) == 5e-3
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_optimizer_state_that_does_not_fit_raises_and_changes_nothing():
    a = _net()
    opt_a = Optimizer(a.parameters(), lr=1e-2)
    _step(a, opt_a, 0)
    state = opt_a.state_dict()
    fewer = Optimizer(list(_net(1).parameters())[:2], lr=1e-2)
    with pytest.raises(ValueError, match='holds 4 parameters'):
        fewer.load_state_dict(state)
    other = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.Linear(5, 2))
    opt = Optimizer(other.parameters(), lr=1e-2)
    with pytest.raises(ValueError, match='exp_avg'):
        opt.load_state_dict(state)
    assert opt.count == 0 and not opt.adam.state


# ----------------------------------------------------------- checkpoints

def test_only_port_checkpoint_files_count(tmp_path):
    d = tmp_path / 'log'
    os.makedirs(d / 'model_000009' / 'default')      # an Orbax step dir
    (d / 'metrics.jsonl').write_text('{}\n')
    (d / 'model_12.pth').write_bytes(b'')
    (d / 'model_000007.pth.123.tmp').write_bytes(b'')
    assert checkpoint.latest_checkpoint(str(d)) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.resolve_checkpoint_dir(str(d))
    with pytest.raises(FileNotFoundError):
        checkpoint.resolve_checkpoint_dir(str(tmp_path / 'missing'))
    built = _built('config/s-coco/detone-orig-lr-5e-3.yaml')
    ckpt = checkpoint.CheckPointer(str(d))
    opt = Optimizer([p for p in built.model.parameters()], lr=1e-3)
    for step in (3, 11):
        ckpt.save(step, built.model, opt)
    assert ckpt.latest_step() == 11
    assert checkpoint.resolve_checkpoint_dir(str(d)) == ckpt.path(11)
    assert checkpoint.resolve_checkpoint_dir(ckpt.path(3)) == ckpt.path(3)
    data = torch.load(ckpt.path(3), weights_only=True)
    assert set(data) == {'model', 'optimizer', 'step'} and data['step'] == 3
    assert all(k.startswith('0.resnet34.') for k in data['model'])


def test_random_sources_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(4)
    rs = np.random.RandomState(5)
    torch.rand(3, generator=gen)
    rs.randn(3)      # leaves a cached gaussian
    state = checkpoint.random_state_dict({'g': gen, 'r': rs})
    torch.save(state, tmp_path / 's.pth')
    state = torch.load(tmp_path / 's.pth', weights_only=True)
    want = (torch.rand(4, generator=gen), rs.randn(5), rs.choice(9, 4))
    gen2, rs2 = torch.Generator(), np.random.RandomState(0)
    fresh = checkpoint.load_random_state({'g': gen2, 'r': rs2, 'x': rs2},
                                         state)
    assert fresh == ['x']
    got = (torch.rand(4, generator=gen2), rs2.randn(5), rs2.choice(9, 4))
    assert torch.equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_array_equal(want[2], got[2])


def _trained(built, steps=2):
    model = built.model
    trainable = [p for p in model.parameters() if p.requires_grad]
    opt = Optimizer(trainable, lr=1e-3)
    for _ in range(steps):
        opt.zero_grad()
        sum(p.square().sum() for p in trainable).backward()
        opt.step()
    return opt


@pytest.mark.parametrize('restart_lr', [False, True])
def test_checkpointer_load_resume_and_restart_learning_rate(restart_lr,
                                                             tmp_path):
    src = _built('config/s-coco/detone-orig-lr-5e-3.yaml')
    opt = _trained(src)
    ckpt = checkpoint.CheckPointer(str(tmp_path))
    ckpt.save(2, src.model, opt)
    dst = _built('config/s-coco/detone-orig-lr-5e-3.yaml', seed=9)
    opt2 = Optimizer([p for p in dst.model.parameters()], lr=1e-3)
    data, step = ckpt.load(dst.model, opt2,
                           restart_learning_rate=restart_lr)
    assert step == 2 and data['step'] == 2
    for (k, a), b in zip(src.model.state_dict().items(),
                         dst.model.state_dict().values()):
        assert torch.equal(a, b), k
    if restart_lr:
        assert opt2.count == 0 and not opt2.adam.state
    else:
        assert opt2.count == 2 and len(opt2.adam.state) == len(opt2.params)
    assert checkpoint.CheckPointer(str(tmp_path / 'new')).load(
        dst.model, opt2) == ({}, 0)


def test_checkpointer_changed_trainable_set_resumes_weights_only(tmp_path,
                                                                 capsys):
    src = _built('config/s-coco/detone-orig-lr-5e-3.yaml')
    opt = _trained(src)
    ckpt = checkpoint.CheckPointer(str(tmp_path))
    ckpt.save(4, src.model, opt)
    dst = _built('config/s-coco/detone-orig-lr-5e-3.yaml', seed=9)
    params = [p for n, p in dst.model.named_parameters() if 'fc' not in n]
    opt2 = Optimizer(params, lr=1e-3)
    _, step = ckpt.load(dst.model, opt2)
    assert step == 4 and opt2.count == 0 and not opt2.adam.state
    assert capsys.readouterr().out.count('resuming weights-only') == 1
    for a, b in zip(src.model.state_dict().values(),
                    dst.model.state_dict().values()):
        assert torch.equal(a, b)


# ------------------------------------------------------------ warm start

def _jax_tree(built):
    """The JAX package's tree of the port's model, by JAX's converters."""
    from bihome_tpu.models import torch_port

    def np_state(module):
        return {k: v.numpy() for k, v in module.state_dict().items()}

    model = built.model
    flavor = built.config['MODEL']['BACKBONE'].get('RESNET_BLOCK',
                                                   'ResNet34')
    parts = {'backbone': torch_port.port_rethinking_full(
        np_state(model.backbone), flavor=flavor)}
    if model.auxiliary_resnet is not None:
        parts['auxiliary_resnet'] = torch_port.port_torchvision_resnet(
            np_state(model.auxiliary_resnet))
    return {c: {name: tree[c] for name, tree in parts.items()}
            for c in ('params', 'batch_stats')}


@pytest.mark.parametrize('source,sets', [
    (ZENG_ORIG, ()),
    (ZENG, ('MODEL.BACKBONE.RESNET_BLOCK=ResNet50',))])
def test_pretrained_counts_follow_jax_merge_matching(source, sets, tmp_path):
    """A zeng-orig checkpoint warm-starts zeng-biHomE: every backbone
    tensor copies, the extractor (absent from the source) is left alone;
    a ResNet50-flavour checkpoint copies only what matches in shape."""
    from bihome_tpu.training.checkpoint import _merge_matching
    src = _built(source, sets, seed=3)
    _randomize_bn(src.model.backbone, 4)
    ckpt = checkpoint.CheckPointer(str(tmp_path))
    ckpt.save(5, src.model, Optimizer(
        [p for p in src.model.parameters() if p.requires_grad], lr=1e-3))
    dst = _built(ZENG)
    aux_before = copy.deepcopy(dst.model.auxiliary_resnet.state_dict())
    stats = [0, 0]
    jdst, jsrc = _jax_tree(dst), _jax_tree(src)
    for c in ('params', 'batch_stats'):
        _merge_matching(jdst[c], jsrc[c], stats)
    copied, skipped = checkpoint.load_pretrained_params(str(tmp_path),
                                                        dst.model)
    assert (copied, skipped) == tuple(stats)
    assert copied > 100 and (skipped == 0) == (not sets)
    src_state = src.model.backbone.state_dict()
    for k, v in dst.model.backbone.state_dict().items():
        if k in src_state and src_state[k].shape == v.shape:
            assert torch.equal(v, src_state[k]), k
    # zeng-orig has no extractor: zeng-biHomE's keeps its own.
    want = (src.model.auxiliary_resnet.state_dict()
            if src.model.auxiliary_resnet is not None else aux_before)
    for k, v in dst.model.auxiliary_resnet.state_dict().items():
        assert torch.equal(v, want[k]), k


# ------------------------------------------------------ torchvision grafts

@pytest.fixture(scope='module')
def torchvision_pth(tmp_path_factory):
    """A seeded torchvision-layout resnet34 .pth (3-channel stem, fc)."""
    net = ResNet('resnet34', output_layer=None, in_channels=3,
                 num_classes=1000)
    backbones.init_weights(net, torch.Generator().manual_seed(21))
    _randomize_bn(net, 22)
    path = tmp_path_factory.mktemp('tv') / 'resnet34.pth'
    torch.save(net.state_dict(), path)
    return str(path), {k: v.numpy() for k, v in net.state_dict().items()}


def _no_counters(state):
    return {k: v for k, v in state.items()
            if not k.endswith('num_batches_tracked')}


def _assert_same(got, want):
    got = _no_counters(got)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], torch.as_tensor(want[k])), k


@pytest.mark.parametrize('config', [
    ZENG, 'config/pds-coco/detone-orig-lr-5e-3.yaml',
    'config/pds-coco/zhang-orig-lr-1e-2.yaml'])
def test_backbone_graft_matches_jax(config, torchvision_pth):
    from bihome_tpu.models import torch_port
    path, tv = torchvision_pth
    built = _built(config, [f'MODEL.BACKBONE.PRETRAINED_RESNET_PATH={path}',
                            'MODEL.BACKBONE.PRETRAINED_RESNET=true'])
    before = {k: v.numpy().copy() for k, v in
              built.model.backbone.state_dict().items()}
    name = built.config['MODEL']['BACKBONE']['NAME']
    if name == 'Rethinking':
        jvars = torch_port.port_rethinking_full(before)
        jvars = torch_port.graft(jvars, torch_port.port_rethinking_encoder(tv))
    else:
        if name == 'ResNet34':
            sub = {k[9:]: v for k, v in before.items()
                   if k.startswith('resnet34.')}
            tree = torch_port.port_torchvision_resnet(sub)
            jvars = {c: {'resnet34': tree[c]}
                     for c in ('params', 'batch_stats')}
        else:
            jvars = torch_port.port_content_aware(before)
        jvars = torch_port.graft(jvars, torch_port.port_torchvision_resnet(
            tv, num_input_channels=2, include_fc=False), ('resnet34',))
    messages = train.load_pretrained_resnets(built)
    assert f'Backbone ImageNet weights loaded from {path}' in messages
    _assert_same(built.model.backbone.state_dict(),
                 weights.state_dict_from_jax(jvars))
    changed = [k for k, v in built.model.backbone.state_dict().items()
               if not np.array_equal(v.numpy(), before[k])]
    assert len(changed) > 50


def test_extractor_graft_matches_jax(torchvision_pth):
    """A torchvision .pth as AUXILIARY_RESNET_PATH: its 3-channel stem is
    summed to the extractor's 1-channel stem, layers past the cut and fc
    are not used."""
    from bihome_tpu.models import torch_port
    path, tv = torchvision_pth
    built = _built(ZENG, [f'MODEL.HEAD.AUXILIARY_RESNET_PATH={path}'])
    aux = built.model.auxiliary_resnet
    assert aux.conv1.weight.shape[1] == 1
    before = {k: v.numpy().copy() for k, v in aux.state_dict().items()}
    jvars = torch_port.graft(
        torch_port.port_torchvision_resnet(before),
        torch_port.port_torchvision_resnet(tv, include_fc=False,
                                           sum_rgb_stem=True))
    want, dropped = aux_store.state_dict_from_aux(jvars, output_layer=1)
    assert {d.split('_')[0] for d in dropped} == {'layer2', 'layer3',
                                                  'layer4'}
    messages = train.load_pretrained_resnets(built)
    assert f'Auxiliary resnet weights loaded from {path}' in messages
    _assert_same(aux.state_dict(), want)
    assert torch.allclose(aux.conv1.weight,
                          torch.from_numpy(tv['conv1.weight']).sum(
                              1, keepdim=True))
