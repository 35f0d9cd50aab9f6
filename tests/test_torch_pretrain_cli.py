"""``python -m bihome_torch.pretrain_aux`` on the CPU and the file it
writes.

Each pretext (and gradpdscl with ``--layers 2``) runs ``--device cpu
--steps 2 --unroll 1 --batch 4 --pool 4`` at the tool's 128x128 patches:
its two losses are finite, its parameters and BN statistics moved, and
the ``.npz`` holds exactly the modules JAX's writer keeps
(``bihome_tpu/utils/aux_store.py:18``: conv1/bn1/layer1, layer2 too for
``--layers 2`` and for rotnet's whole network), equal to the trained
model's. JAX's ``load_aux_npz`` reads it, and JAX's ``ResNet(output_layer
= 1 | 2)`` on it gives the port's extractor's features from the same file
(eval mode, float32, within 1e-4 of the largest entry). The port's train
entry point takes the gradcl file through MODEL.HEAD.AUXILIARY_RESNET_PATH
into its frozen extractor.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bihome_tpu.models.resnet import ResNet as JResNet
from bihome_tpu.utils import aux_store as jaux
from bihome_torch import pretrain_aux
from bihome_torch.models import weights
from bihome_torch.models.resnet import ResNet
from bihome_torch.utils import aux_store


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """torch's CPU ops on one thread while this file runs: its CPU work is
    small, and the parallel test run's workers then do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RUNS = {name: (name, ()) for name in pretrain_aux.PRETEXTS}
RUNS['gradpdscl layers 2'] = ('gradpdscl', ('--layers', '2'))


@pytest.fixture(scope='module')
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp('aux')
    out = {}
    for case, (name, extra) in RUNS.items():
        path = str(root / f'aux_{case.replace(" ", "_")}.npz')
        result = pretrain_aux.main(
            ['--device', 'cpu', '--steps', '2', '--unroll', '1', '--batch',
             '4', '--pool', '4', '--pretext', name, '--out', path, *extra])
        out[case] = (path, result)
    return out


@pytest.mark.parametrize('case', sorted(RUNS))
def test_cli_trains_and_writes_what_jax_keeps(written, case):
    path, result = written[case]
    assert result['losses'].shape == (2,)
    assert bool(torch.isfinite(result['losses']).all())
    final = result['model'].state_dict()
    initial = result['initial_state']
    for key, value in final.items():
        if key.endswith('num_batches_tracked'):
            continue
        assert not torch.equal(value, initial[key]), key
    deep = case == 'rotnet' or 'layers 2' in case
    want = ['conv1', 'bn1', 'layer1'] + (['layer2'] if deep else [])
    assert result['kept'] == want
    with np.load(path) as data:
        tops = {k.split('/')[1].split('_')[0] for k in data.files}
        assert tops == set(want)
        assert all(k.startswith(('params/', 'batch_stats/'))
                   for k in data.files)
    state, dropped = aux_store.state_dict_from_aux(
        aux_store.load_aux_npz(path), 2)
    assert dropped == []
    for key, value in state.items():
        torch.testing.assert_close(value, final[key], rtol=0, atol=0,
                                   msg=key)


@pytest.mark.parametrize('case,layer', [
    ('gradcl', 1), ('gradpdscl layers 2', 1), ('gradpdscl layers 2', 2),
    ('rotnet', 1), ('rotnet', 2)])
def test_jax_reads_the_file_and_gives_the_port_features(written, case,
                                                        layer):
    path, _ = written[case]
    x = np.random.RandomState(layer).randn(2, 32, 32, 1).astype(np.float32)
    jmodel = JResNet(arch='resnet34', output_layer=layer)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pruned, dropped = jaux.prune_to_template(jaux.load_aux_npz(path),
                                             template)
    assert dropped == ([] if layer == 2 or case == 'gradcl'
                       else ['batch_stats/layer2_0', 'batch_stats/layer2_1',
                             'batch_stats/layer2_2', 'batch_stats/layer2_3',
                             'params/layer2_0', 'params/layer2_1',
                             'params/layer2_2', 'params/layer2_3'])
    want = np.asarray(jmodel.apply(pruned, jnp.asarray(x), train=False))
    model = ResNet('resnet34', output_layer=layer)
    state, _ = aux_store.state_dict_from_aux(aux_store.load_aux_npz(path),
                                             layer)
    weights.load_state_dict(model, state)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_train_cli_takes_the_file(written, tmp_path):
    from bihome_torch import train
    path, _ = written['gradcl']
    result = train.main([
        '--config_file', 'config/s-coco/zeng-bihome-lr-1e-3.yaml',
        '--synthetic', '--steps', '1', '--batch_size', '2', '--epochs', '1',
        '--device', 'cpu', '--set', f'LOGGING.DIR={tmp_path / "log"}',
        '--set', f'MODEL.HEAD.AUXILIARY_RESNET_PATH={path}'])
    kernel = np.load(path)['params/conv1/kernel']
    np.testing.assert_array_equal(
        result['model'].auxiliary_resnet.conv1.weight.detach().numpy(),
        np.transpose(kernel, (3, 2, 0, 1)))
    assert bool(torch.isfinite(result['losses']).all())
    assert os.path.exists(result['checkpoint'])
