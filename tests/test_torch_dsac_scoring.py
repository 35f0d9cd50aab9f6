"""DSAC with several hypotheses in the port against the JAX package, on
the CPU: ``bihome_torch.heads.dsac`` (``sample_hypotheses``, the four
``score_hypotheses`` methods, ``refine_hypotheses``), the score CNN, and
the PerceptualHead's general DSAC branch in training and at predict.

* ``sample_hypotheses`` on noisy clouds of a homography (batch 2, 256
  points, 3 hypotheses of 16 points), JAX's ``sample_point_indices``
  monkeypatched to the indices of the same uniforms: the hypotheses'
  corner deltas within 1e-3 px.
* ``score_hypotheses`` with each method on the hypotheses of clouds with
  0.01 px of noise (larger errors, summed over 256 points, saturate the
  softmax, whose gradient is then 0 on both sides): scores
  within 1e-5 (atol; rtol 1e-5), the reprojection tensor within 1e-4 px,
  and the gradient of a weighted sum of the scores with respect to the
  target points within 1e-4 of its largest entry (the score_cnn method
  with a plain callable on both sides; inliers_ratio has none).
* ``refine_hypotheses`` (weights 1 - distance): corner deltas within
  1e-3 px.
* The score CNN, a 2-channel resnet18 with a 1-unit fc, against flax's
  ``ResNet('resnet18', num_classes=1)`` on carried weights with random
  BN statistics, in eval mode as the head calls it: outputs within 1e-5
  (rtol 1e-4), the input and parameter gradients within 1e-4 of each
  tensor's largest entry.
* The ``inliers_ratio`` quirk: softmax(-ratio) gives the hypothesis with
  fewer inliers the larger weight, in both packages.
* One zeng-biHomE training step at n = 3 (S-COCO config cut to 32x32
  patches, rho 8, batch 2; the frozen extractor from aux_clfbh.npz; a
  3x3-conv backbone that maps the patch pair to the perspective fields,
  in place of the Rethinking network, whose JAX compile would cost
  minutes here), with repr_error on the double-line loss and with
  score_cnn on the one-line loss (the double-line loss weighs nothing by
  the scores, so only there does the score CNN take a gradient): the
  port's ``trainer.train_step`` against JAX's loss under
  ``jax.value_and_grad``, the DSAC draws injected as
  ``tests/test_torch_train_step.py`` injects them. Loss and metrics rtol
  1e-4 (atol 1e-6), each gradient within 1e-3 of its largest entry.
* Predict on given fields at n = 3 (repr_error, soft_inliers_ratio,
  score_cnn, and a tie of every score), JAX's draws read off the keys its
  ``sample_point_indices`` gets: the best hypothesis's delta within 1e-3
  px; ties go to the first hypothesis on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from bihome_tpu import geometry as jgeo
from bihome_tpu.data import pipeline as jpipe
from bihome_tpu.heads import assembled as jassembled
from bihome_tpu.heads import dsac as jdsac
from bihome_tpu.heads.config import HeadConfig as JHeadConfig
from bihome_tpu.models.resnet import ResNet as JResNet
from bihome_tpu.training import losses as jlosses
from bihome_tpu.utils import aux_store as jaux
from bihome_torch.config import build_model, load_config
from bihome_torch.data import pipeline as tpipe
from bihome_torch.heads import dsac as tdsac
from bihome_torch.heads.assembled import AssembledModel
from bihome_torch.heads.config import HeadConfig
from bihome_torch.models import weights
from bihome_torch.models.resnet import ResNet
from bihome_torch.training import trainer
from bihome_torch.training.train_state import Optimizer
from bihome_torch.utils import aux_store
from tests.test_torch_backbone import randomize_variables
from tests.test_torch_datagen import ZENG, _injected, _small_spec
from tests.test_torch_predict_refine import _jax_predict, _noisy_field
from tests.test_torch_train_step import _indices

N_HYP, PPH = 3, 16
METHODS = ('repr_error', 'inliers_ratio', 'soft_inliers_ratio', 'score_cnn')


def _clouds(b=2, side=16, seed=0, noise=0.3, outliers=0.1):
    """Grid points [b, side^2, 2] and their images under a random
    homography plus normal noise and a share of gross outliers."""
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(side, dtype=np.float32),
                         np.arange(side, dtype=np.float32), indexing='ij')
    p1 = np.broadcast_to(np.stack([xs.ravel(), ys.ravel()], -1)[None],
                         (b, side * side, 2)).copy()
    fp = jgeo.image_corners(side, side, batch_size=b)
    h = jgeo.four_point_to_homography(
        fp, jnp.asarray(rs.uniform(-3, 3, (b, 4, 2)).astype(np.float32)))
    p2 = np.asarray(jgeo.transform_points(h, jnp.asarray(p1)))
    p2 = p2 + rs.normal(0, noise, p2.shape)
    p2 = p2 + ((rs.rand(b, side * side, 1) < outliers)
               * rs.uniform(-8, 8, p2.shape))
    return p1.astype(np.float32), p2.astype(np.float32)


def _deltas(h, side=16):
    """Corner deltas [..., 4, 2] of homographies [..., 3, 3]."""
    h = np.asarray(h).reshape(-1, 3, 3)
    fp = jgeo.image_corners(side, side, batch_size=h.shape[0])
    return np.asarray(jgeo.transform_points(jnp.asarray(h), fp) - fp)


def _jax_hypotheses(p1, p2, u, monkeypatch):
    monkeypatch.setattr(jdsac, 'sample_point_indices',
                        lambda key, shape, n, s: _indices(u, n))
    return jax.jit(lambda a, b: jdsac.sample_hypotheses(
        a, b, jax.random.PRNGKey(0), N_HYP, PPH))(jnp.asarray(p1),
                                                  jnp.asarray(p2))


def test_sample_hypotheses_matches_jax(monkeypatch):
    p1, p2 = _clouds()
    u = np.random.RandomState(1).uniform(0, 1, (2, N_HYP * PPH)).astype(
        np.float32)
    idx = tdsac.sample_point_indices((2, N_HYP * PPH), p1.shape[1],
                                     'reference-weighted', torch.from_numpy(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(_indices(u, 256)))
    want = _jax_hypotheses(p1, p2, u, monkeypatch)
    got = tdsac.sample_hypotheses(torch.from_numpy(p1), torch.from_numpy(p2),
                                  N_HYP, PPH, uniforms=torch.from_numpy(u))
    assert got.shape == (2, N_HYP, 3, 3)
    np.testing.assert_allclose(_deltas(got.numpy()), _deltas(want),
                               rtol=0, atol=1e-3)


def _score_fns():
    """The score_cnn method's callable, a plain function on both sides."""
    w = np.random.RandomState(7).randn(2).astype(np.float32)

    def jfn(img):
        return jnp.mean(jnp.tanh(10.0 * img) * w, axis=(1, 2, 3))[:, None]

    def tfn(img):
        return (torch.tanh(10.0 * img) * torch.from_numpy(w)).mean(
            (1, 2, 3))[:, None]
    return jfn, tfn


@pytest.mark.parametrize('method', METHODS)
def test_score_hypotheses_matches_jax(method, monkeypatch):
    # Small errors: summed over 256 points, larger ones saturate the
    # softmax over the hypotheses, and its gradient is 0 on both sides.
    p1, p2 = _clouds(seed=2, noise=0.01, outliers=0.0)
    u = np.random.RandomState(3).uniform(0, 1, (2, N_HYP * PPH)).astype(
        np.float32)
    hyps = np.array(_jax_hypotheses(p1, p2, u, monkeypatch))
    jfn, tfn = _score_fns()
    g = np.random.RandomState(4).randn(2, N_HYP).astype(np.float32)

    def jscore(q2):
        s, r = jdsac.score_hypotheses(jnp.asarray(p1), q2, jnp.asarray(hyps),
                                      method, 3.0, 1.0, jfn)
        return jnp.sum(s * g), (s, r)
    (_, (want_s, want_r)), want_g = jax.value_and_grad(jscore, has_aux=True)(
        jnp.asarray(p2))
    q2 = torch.from_numpy(p2).requires_grad_(True)
    got_s, got_r = tdsac.score_hypotheses(torch.from_numpy(p1), q2,
                                          torch.from_numpy(hyps), method,
                                          3.0, 1.0, tfn)
    if got_s.requires_grad:
        (got_s * torch.from_numpy(g)).sum().backward()
    assert got_s.shape == (2, N_HYP)
    assert got_r.shape == np.asarray(want_r).shape
    np.testing.assert_allclose(got_s.detach().numpy(), want_s, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_r.detach().numpy(), want_r, rtol=1e-5,
                               atol=1e-4)
    want_g = np.asarray(want_g)
    if method == 'inliers_ratio':
        # A count: no gradient into the points on either side.
        assert np.abs(want_g).max() == 0 and not got_s.requires_grad
    else:
        scale = np.abs(want_g).max()
        assert scale > 0
        np.testing.assert_allclose(q2.grad.numpy(), want_g, rtol=0,
                                   atol=1e-4 * scale)


def test_refine_hypotheses_matches_jax():
    p1, p2 = _clouds(seed=5)
    d = np.random.RandomState(6).uniform(0, 0.9, (2, N_HYP, 256)).astype(
        np.float32)
    want = jax.jit(jdsac.refine_hypotheses, static_argnums=3)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(d), N_HYP)
    got = tdsac.refine_hypotheses(torch.from_numpy(p1), torch.from_numpy(p2),
                                  torch.from_numpy(d), N_HYP)
    assert got.shape == (2, N_HYP, 3, 3)
    np.testing.assert_allclose(_deltas(got.numpy()), _deltas(want), rtol=0,
                               atol=1e-3)


def _score_cnn_pair(seed=0):
    """flax's score CNN with random BN statistics, and the port's with
    the same weights (``weights`` maps flax's ResNet trees)."""
    jnet = JResNet(arch='resnet18', num_classes=1)
    variables = randomize_variables(
        jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 32, 32, 2))),
        np.random.RandomState(seed))
    tnet = ResNet('resnet18', output_layer=None, in_channels=2,
                  num_classes=1)
    state, _ = aux_store.state_dict_from_aux(variables, output_layer=4)
    weights.load_state_dict(tnet, state)
    return jnet, variables, tnet.eval()


def test_score_cnn_matches_flax_on_carried_weights():
    jnet, variables, tnet = _score_cnn_pair()
    rs = np.random.RandomState(1)
    x = rs.randn(3, 32, 32, 2).astype(np.float32)
    g = rs.randn(3, 1).astype(np.float32)

    def jloss(params, x):
        out = jnet.apply({'params': params,
                          'batch_stats': variables['batch_stats']}, x,
                         train=False)
        return jnp.sum(out * g), out
    (_, want), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables['params'],
                                              jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tnet(xt.permute(0, 3, 1, 2))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    want_gx = np.asarray(want_gx)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=0,
                               atol=1e-4 * np.abs(want_gx).max())
    want_p, _ = aux_store.state_dict_from_aux(
        {'params': jax.tree_util.tree_map(np.asarray, want_gp)}, 4)
    params = dict(tnet.named_parameters())
    assert set(want_p) == set(params)
    for name, w in want_p.items():
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(),
                                   rtol=0, atol=1e-4 * w.abs().max().item(),
                                   err_msg=name)


def test_inliers_ratio_weighs_the_hypothesis_with_fewer_inliers_more():
    """ref: ransac_utils.py:126 takes softmax(-ratio): a quirk of the
    reference, kept by both packages."""
    p1, _ = _clouds(b=1)
    fp = jgeo.image_corners(16, 16, batch_size=2)
    h = np.asarray(jgeo.four_point_to_homography(fp, jnp.asarray(
        np.array([[[1, 0], [0, 1], [-1, 0], [0, 0]],
                  [[9, 9], [-9, 9], [9, -9], [-9, -9]]], np.float32))))
    p2 = np.array(jgeo.transform_points(jnp.asarray(h[:1]),
                                        jnp.asarray(p1)))
    hyps = h[None]                                     # [1, 2, 3, 3]
    want, _ = jdsac.score_hypotheses(jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(hyps), 'inliers_ratio')
    got, err = tdsac.score_hypotheses(torch.from_numpy(p1),
                                      torch.from_numpy(p2),
                                      torch.from_numpy(hyps),
                                      'inliers_ratio')
    ratios = (err < 3.0).float().mean(-1)[0]
    assert ratios[0] == 1.0 and ratios[1] < 0.5
    assert got[0, 1] > got[0, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ whole step

class JTiny(fnn.Module):
    """A 3x3 conv from the patch pair to the perspective field(s)."""
    doubleline: bool = True

    @fnn.compact
    def __call__(self, batch, train=False):
        conv = fnn.Conv(2, (3, 3), padding=1, name='conv')
        p1, p2 = batch['patch_1'], batch['patch_2']
        out = {'pf_hat_12': conv(jnp.concatenate([p1, p2], -1))}
        if self.doubleline:
            out['pf_hat_21'] = conv(jnp.concatenate([p2, p1], -1))
        return out


class TTiny(torch.nn.Module):
    def __init__(self, doubleline=True):
        super().__init__()
        self.doubleline = doubleline
        self.conv = torch.nn.Conv2d(2, 2, 3, padding=1)

    def forward(self, batch):
        def field(a, b):
            x = torch.cat([a, b], -1).permute(0, 3, 1, 2)
            return self.conv(x).permute(0, 2, 3, 1)
        p1, p2 = batch['patch_1'], batch['patch_2']
        out = {'pf_hat_12': field(p1, p2)}
        if self.doubleline:
            out['pf_hat_21'] = field(p2, p1)
        return out


STEP_CASES = {'repr_error double-line': ('repr_error', 'double-line'),
              'score_cnn one-line': ('score_cnn', 'one-line')}


def _heads(method, loss, **extra):
    config = load_config(ZENG[0])
    head = dict(config['MODEL']['HEAD'], PATCH_SIZE=32,
                RANSAC_HYPOTHESIS_NO=N_HYP, SCORING_METHOD=method,
                TRIPLET_LOSS=loss, **extra)
    if loss == 'one-line':
        head['PF_KEYS'] = ['pf_hat_12']
    return HeadConfig.from_yaml(head), JHeadConfig.from_yaml(head)


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_train_step_at_three_hypotheses_matches_jax(case, monkeypatch):
    method, loss = STEP_CASES[case]
    doubleline = loss == 'double-line'
    head, jhead = _heads(method, loss)
    spec = _small_spec(jpipe)
    images, corners, delta = _injected(seed=8)
    corners, delta = corners.astype(np.int32), delta.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    batch = jpipe._assemble_pairs(jnp.asarray(images), jnp.asarray(corners),
                                  jnp.asarray(delta), keys, keys, spec)
    jmodel = jassembled.AssembledModel(backbone=JTiny(doubleline), head=jhead)
    rs = np.random.RandomState(9)
    u = [rs.uniform(0, 1, (2, N_HYP * 128)).astype(np.float32)
         for _ in range(2)]
    draws = iter(u)
    monkeypatch.setattr(jdsac, 'sample_point_indices',
                        lambda key, shape, n, s: _indices(next(draws), n))
    init = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(1), 'dsac': jax.random.PRNGKey(2)},
        batch))
    init = jax.tree_util.tree_map(
        lambda x: np.asarray(rs.randn(*x.shape) * np.sqrt(
            2.0 / max(1, np.prod(x.shape[:-1]))), np.float32), init)
    draws = iter(u)
    variables = {c: dict(jax.tree_util.tree_map(np.asarray, init[c]))
                 for c in ('params', 'batch_stats') if c in init}
    variables.setdefault('batch_stats', {})
    variables['params']['backbone'] = {'conv': {
        'kernel': (rs.randn(3, 3, 2, 2) * 0.2).astype(np.float32),
        'bias': (rs.randn(2) * 0.5).astype(np.float32)}}
    aux = jaux.load_aux_npz('aux_clfbh.npz')
    for c in ('params', 'batch_stats'):
        variables[c]['auxiliary_resnet'] = aux[c]
    if method == 'score_cnn':
        score = randomize_variables(
            {c: variables[c]['score_cnn'] for c in ('params', 'batch_stats')},
            rs)
        for c in score:
            variables[c]['score_cnn'] = score[c]

    # Traced once under jit: the two DSAC calls take the injected draws in
    # order, 1->2 first.
    def loss_fn(params):
        params = {k: (jax.lax.stop_gradient(v)
                      if k.startswith('auxiliary_resnet') else v)
                  for k, v in params.items()}
        out, _ = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch, train=True, rngs={'dsac': jax.random.PRNGKey(5)},
            mutable=['batch_stats'])
        return jlosses.compute_loss('biHomE', out), out
    (jloss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    want = {'loss/train': jloss, 'g_norm/value': optax.global_norm(grads),
            'mace/train': jgeo.mace(out['delta_gt'], out['delta_hat'])}
    want.update(out['metrics'])

    model = AssembledModel(TTiny(doubleline), head)
    with torch.no_grad():
        kernel = variables['params']['backbone']['conv']['kernel']
        model.backbone.conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        model.backbone.conv.bias.copy_(torch.from_numpy(
            variables['params']['backbone']['conv']['bias']))
    state = weights.state_dict_from_jax(
        {c: {**variables[c], 'backbone': {}} for c in variables})
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all(k.startswith('backbone.') or
                                  k.endswith('num_batches_tracked')
                                  for k in missing)
    opt = Optimizer([p for p in model.parameters() if p.requires_grad],
                    lr=1e-3)
    got = trainer.train_step(
        model, opt, torch.from_numpy(images).to(torch.uint8),
        _small_spec(tpipe), 'biHomE',
        corners=torch.from_numpy(corners), delta=torch.from_numpy(delta),
        uniforms=[torch.from_numpy(x) for x in u])
    assert set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    want_g = {'backbone.conv.weight': np.asarray(
        grads['backbone']['conv']['kernel']).transpose(3, 2, 0, 1),
              'backbone.conv.bias': np.asarray(
        grads['backbone']['conv']['bias'])}
    if method == 'score_cnn':
        want_g.update({k: v.numpy() for k, v in weights.state_dict_from_jax(
            {'params': {'backbone': {}, 'score_cnn': jax.tree_util.tree_map(
                np.asarray, grads['score_cnn'])}}).items()})
    params = dict(model.named_parameters())
    for name, w in want_g.items():
        if name == 'score_cnn.fc.bias':
            # A shift of every score: softmax ignores it, its gradient is
            # analytically 0.
            assert abs(w).max() < 1e-6 and params[name].grad.abs().max() < 1e-6
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(params[name].grad.numpy(), w, rtol=0,
                                   atol=1e-3 * scale, err_msg=name)


# --------------------------------------------------------------- predict

class _JFields(fnn.Module):
    @fnn.compact
    def __call__(self, data, train=False):
        return {'pf_hat_12': data['pf12'], 'pf_hat_21': data['pf21']}


class _TFields(torch.nn.Module):
    def forward(self, batch):
        return {'pf_hat_12': batch['pf12'], 'pf_hat_21': batch['pf21']}


@pytest.mark.parametrize('method,extra', [
    ('repr_error', {}), ('soft_inliers_ratio', {}), ('score_cnn', {}),
    ('inliers_ratio', {'SCORING_DISTANCE_THRESHOLD': 1e6})])
def test_predict_takes_the_best_hypothesis_as_jax(method, extra,
                                                  monkeypatch):
    pf12, _ = _noisy_field(b=2, seed=4)
    pf21, _ = _noisy_field(b=2, seed=5)
    head, jhead = _heads(method, 'double-line', **extra)
    jmodel = jassembled.AssembledModel(backbone=_JFields(), head=jhead)
    jbatch = {'pf12': jnp.asarray(pf12), 'pf21': jnp.asarray(pf21)}
    model = AssembledModel(_TFields(), head)
    variables = {}
    if method == 'score_cnn':
        variables = randomize_variables(jmodel.init(
            {'params': jax.random.PRNGKey(1), 'dsac': jax.random.PRNGKey(2)},
            jbatch, method='predict'), np.random.RandomState(3))
        weights.load_state_dict(model.score_cnn, {
            k[len('score_cnn.'):]: v for k, v in weights.state_dict_from_jax(
                {c: {**variables[c], 'backbone': {}}
                 for c in variables}).items()})
    want, uniforms = _jax_predict(jmodel, variables, jbatch, monkeypatch)
    assert [tuple(x.shape) for x in uniforms] == [(2, N_HYP * 128)]
    model.eval()
    batch = {'pf12': torch.from_numpy(pf12), 'pf21': torch.from_numpy(pf21)}
    got = model.predict(batch, uniforms=uniforms)
    deltas, scores = model.dsac_deltas(batch['pf12'], uniforms[0])
    best = scores.argmax(-1)
    if 'SCORING_DISTANCE_THRESHOLD' in extra:
        # Every point an inlier: equal scores, the first hypothesis wins.
        assert torch.all(scores == scores[:, :1]) and torch.all(best == 0)
    else:
        assert torch.all(scores.max(-1).values > scores.min(-1).values)
    assert got.shape == (2, 4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(
        got.numpy(), deltas.reshape(2, N_HYP, 4, 2)[torch.arange(2),
                                                    best].numpy())


def test_build_model_takes_several_hypotheses_and_score_cnn():
    config = load_config(ZENG[0])
    config['MODEL']['HEAD'].update({'RANSAC_HYPOTHESIS_NO': 4,
                                    'SCORING_METHOD': 'score_cnn'})
    built = build_model(config)
    assert built.head_cfg.hypothesis_no == 4
    cnn = built.model.score_cnn
    assert cnn.conv1.weight.shape == (64, 2, 7, 7)
    assert cnn.fc.weight.shape == (1, 512)
    built.model.train()
    assert not cnn.training and built.model.backbone.training
    assert all(p.requires_grad for p in cnn.parameters())
