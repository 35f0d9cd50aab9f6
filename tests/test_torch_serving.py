"""The port's serving export (``bihome_torch.serving``, mirroring
tests/test_serving.py): a ``torch.export`` artifact of the predict chain
with the weights held in it, saved, loaded and held to the live serving
function, on the CPU.

* detone-orig (no draws): the live serving function equals JAX's
  ``make_serving_fn`` on the same weights (random BN statistics and
  affines) within 1e-4 px (float32, two implementations); the artifact
  equals the live function exactly at batches 1 and 4 of one
  batch-polymorphic export (the same ops on the same device), and two
  calls give the same bits; a fixed-batch artifact's input signature; the
  weights are the artifact's (changing the live model after the export
  changes nothing; an export of changed weights differs).
* a small zeng-biHomE (tests/test_torch_train_step.py's, 32x32 patches;
  DSAC): JAX's fixed-PRNGKey draws cannot be reproduced, so the serving
  function equals the port's ``AssembledModel.predict`` given its fixed
  uniforms (held to JAX by tests/test_torch_predict*.py) exactly; the
  artifact equals the live function at batches 1 and 4 and holds
  ``bihome::pf_head_fwd``.
* ``python -m bihome_torch.export_model --check`` (its 1e-3 px limit) and
  ``bihome_torch.bench_serving --json``, run in this process on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from bihome_tpu import config as jconfig
from bihome_tpu import serving as jserving
from bihome_tpu.data import datasets as jdatasets
from bihome_tpu.training import train_state as jts
from bihome_tpu.training import trainer as jtrainer
from bihome_torch import bench_serving, export_model, serving
from bihome_torch import config as tconfig
from bihome_torch.models import weights
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_train_step import _small_config
from tests.torch_threads import one_torch_thread  # noqa: F401

DETONE = 'config/s-coco/detone-orig-lr-5e-3.yaml'


def _port_model(config, state):
    built = tconfig.build_model(config)
    weights.load_state_dict(built.model, state)
    return built


@pytest.fixture(scope='module')
def detone(tmp_path_factory):
    """JAX's detone-orig state with random BN statistics and affines, its
    serving function at batch 2, the port model with the same weights,
    and the port's batch-polymorphic artifact, saved and loaded."""
    config = jconfig.load_config(DETONE)
    built = jconfig.build_model(config)
    tx, _ = jts.make_optimizer(**jconfig.solver_kwargs(config))
    ds = jdatasets.SyntheticDataset(image_size=(320, 240), seed=7)
    variables = jtrainer.init_model(built, np.stack([ds.load_image(0)]))
    rs = np.random.RandomState(5)
    variables = {c: randomize_variables(variables[c], rs)
                 for c in ('params', 'batch_stats')}
    state = jts.create_train_state(variables, tx)
    serve, _ = jserving.make_serving_fn(built, state, batch_size=2)
    tbuilt = _port_model(tconfig.load_config(DETONE),
                         weights.state_dict_from_jax(variables))
    path = str(tmp_path_factory.mktemp('serving') / 'detone.pt2')
    serving.save_exported(serving.export_predict(
        tbuilt, tbuilt.model, 'b'), path)
    return {'jax_serve': jax.jit(serve), 'built': tbuilt, 'path': path}


def _patches(b, ps=128, ch=1, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, ps, ps, ch).astype(np.float32) for _ in range(2)]


def test_live_serving_function_matches_jax(detone):
    live, shapes = serving.make_serving_fn(detone['built'],
                                           detone['built'].model, 2)
    assert shapes == ((2, 128, 128, 1), (2, 128, 128, 1))
    p1, p2 = _patches(2)
    with torch.no_grad():
        got = live(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    want = np.asarray(detone['jax_serve'](p1, p2))
    assert got.shape == (2, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_symbolic_batch_artifact_equals_live_and_is_deterministic(detone):
    predict = serving.load_exported(detone['path'])
    live, _ = serving.make_serving_fn(detone['built'], detone['built'].model,
                                      'b')
    for b in (1, 4):
        p1, p2 = (torch.from_numpy(p) for p in _patches(b, seed=b))
        got = predict(p1, p2)
        with torch.no_grad():
            want = live(p1, p2)
        assert got.shape == (b, 4, 2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(predict(p1, p2), got)
    shapes = serving.exported_input_shapes(detone['path'])
    assert isinstance(shapes[0][0], str) and shapes[0][1:] == (128, 128, 1)


def test_input_signature_peek(detone, tmp_path):
    path = str(tmp_path / 'b2.pt2')
    serving.save_exported(serving.export_predict(
        detone['built'], detone['built'].model, 2), path)
    assert serving.exported_input_shapes(path) == ((2, 128, 128, 1),
                                                   (2, 128, 128, 1))


def test_weights_are_in_the_artifact(detone, tmp_path):
    model = detone['built'].model
    p1, p2 = (torch.from_numpy(p) for p in _patches(1, seed=3))
    before = serving.load_exported(detone['path'])(p1, p2)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05)
        # The artifact on disk holds its own weights ...
        torch.testing.assert_close(
            serving.load_exported(detone['path'])(p1, p2), before, rtol=0,
            atol=0)
        # ... and an export of the changed weights differs.
        path = str(tmp_path / 'bumped.pt2')
        serving.save_exported(serving.export_predict(
            detone['built'], model, 1), path)
        bumped = serving.load_exported(path)(p1, p2)
    finally:
        model.load_state_dict(saved)
    assert not torch.allclose(bumped, before)


@pytest.fixture(scope='module')
def zeng(tmp_path_factory):
    """The small zeng-biHomE with seeded weights and its artifact."""
    built = tconfig.build_model(_small_config(tconfig))
    from bihome_torch.models import backbones
    backbones.init_weights(built.model.backbone,
                           torch.Generator().manual_seed(4))
    built.model.eval()
    path = str(tmp_path_factory.mktemp('serving') / 'zeng.pt2')
    exported = serving.export_predict(built, built.model, 'b')
    serving.save_exported(exported, path)
    return {'built': built, 'path': path, 'ops': serving.graph_ops(exported)}


def test_zeng_serving_function_is_predict_on_its_draws(zeng):
    built = zeng['built']
    live, _ = serving.make_serving_fn(built, built.model, 'b')
    p1, p2 = (torch.from_numpy(p) for p in _patches(3, ps=32))
    draws = serving.serving_draws(built.model, serving.MAX_BATCH, 32)
    batch = {'patch_1': p1, 'patch_2': p2}
    want = built.model.predict(batch, uniforms=draws['u12'][:3])
    with torch.no_grad():
        got = live(p1, p2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_zeng_artifact_round_trip(zeng):
    built = zeng['built']
    assert 'bihome.pf_head_fwd.default' in zeng['ops']
    predict = serving.load_exported(zeng['path'])
    live, _ = serving.make_serving_fn(built, built.model, 'b')
    for b in (1, 4):
        p1, p2 = (torch.from_numpy(p) for p in _patches(b, ps=32, seed=b))
        got = predict(p1, p2)
        with torch.no_grad():
            want = live(p1, p2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(predict(p1, p2), got)


def test_export_model_check_and_bench_serving(tmp_path, capsys):
    out = str(tmp_path / 'cli.pt2')
    result = export_model.main([
        '--config_file', DETONE, '--out', out, '--batch_size', 'b',
        '--device', 'cpu', '--check',
        '--set', f'LOGGING.DIR={tmp_path / "nolog"}'])
    assert result['check_err_px'] < export_model.CHECK_LIMIT_PX
    assert 'check: max |exported - live|' in capsys.readouterr().out
    line = bench_serving.main(['--artifact', out, '--batch', '2', '--iters',
                               '2', '--warmup', '1', '--json'])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    parsed = json.loads(printed)
    assert parsed['metric'] == 'serving_latency_ms'
    assert parsed['value'] > 0 and parsed['batch'] == 2
    assert parsed['platform'] == 'cpu' and parsed['device'] == 'cpu'
    assert parsed == line
