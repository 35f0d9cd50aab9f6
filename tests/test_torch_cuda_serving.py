"""The registered PF-head op and the serving artifact on the card.

Marked ``cuda``: each test skips without a CUDA device. Imports no JAX.

* ``bihome::pf_head_fwd`` on CUDA tensors launches K1 (its counter moves)
  and returns the wrapper's bits; its fake gives [N,Cout,H,W] in x's
  dtype.
* The serving artifact of a seeded zeng-biHomE (32x32 patches), exported
  on the card at a symbolic batch, saved and loaded: its graph holds the
  op, it launches K1, equals the live serving function at batches 1 and
  3 within 1e-3 px, and two calls give the same bits.
"""

import pytest
import torch

from bihome_torch import config as tconfig
from bihome_torch import serving
from bihome_torch.models import backbones
from bihome_torch.ops import fused_head

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _head_args(device, n=2, cin=16, cmid=128, hw=(16, 16)):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n, cin) + hw, generator=gen)
    w1 = torch.randn(cmid, cin, 1, 1, generator=gen) * 0.3
    b1 = torch.randn(cmid, generator=gen) * 0.1
    gamma = 1 + 0.1 * torch.randn(cmid, generator=gen)
    beta = 0.1 * torch.randn(cmid, generator=gen)
    w2 = torch.randn(2, cmid, 1, 1, generator=gen) * 0.3
    b2 = torch.randn(2, generator=gen) * 0.1
    mean = 0.1 * torch.randn(cmid, generator=gen)
    var = 0.5 + torch.rand(cmid, generator=gen)
    return [t.to(device) for t in (x, w1, b1, gamma, beta, w2, b2, mean,
                                   var)] + [1e-5]


def test_op_launches_k1_with_the_wrappers_bits(cuda):
    args = _head_args(cuda)
    before = fused_head.fused_pf_head_fwd.launches
    got = fused_head.pf_head_fwd_op(*args)
    assert fused_head.fused_pf_head_fwd.launches == before + 1
    torch.testing.assert_close(got, fused_head.fused_pf_head_fwd(*args),
                               rtol=0, atol=0)
    assert got.shape == (2, 2, 16, 16) and got.dtype == torch.float32


def test_artifact_on_the_card(cuda, tmp_path):
    # tests/test_torch_train_step.py's cut (that file imports JAX).
    config = tconfig.load_config('config/s-coco/zeng-bihome-lr-1e-3.yaml')
    config['MODEL']['HEAD']['PATCH_SIZE'] = 32
    config['DATA']['TRANSFORMS'][0]['HomographyNetPrep'][:2] = [8, 32]
    built = tconfig.build_model(config)
    backbones.init_weights(built.model.backbone,
                           torch.Generator().manual_seed(4))
    model = built.model.to(cuda).eval()
    exported = serving.export_predict(built, model, 'b', device=cuda)
    assert 'bihome.pf_head_fwd.default' in serving.graph_ops(exported)
    path = str(tmp_path / 'zeng.pt2')
    serving.save_exported(exported, path)
    predict = serving.load_exported(path)
    live, _ = serving.make_serving_fn(built, model, 'b')
    gen = torch.Generator().manual_seed(1)
    for b in (1, 3):
        p1, p2 = (torch.randn(b, 32, 32, 1, generator=gen).to(cuda)
                  for _ in range(2))
        before = fused_head.fused_pf_head_fwd.launches
        got = predict(p1, p2)
        assert fused_head.fused_pf_head_fwd.launches == before + 1
        with torch.no_grad():
            want = live(p1, p2)
        assert float((got - want).abs().max()) <= 1e-3
        assert torch.equal(predict(p1, p2), got)
