"""Serving export: a trained model as one self-contained ``torch.export``
artifact (counterpart of ``bihome_tpu/serving.py:24-117``).

    from bihome_torch import serving
    predict = serving.load_exported('model.pt2')
    delta_hat = predict(patch_1, patch_2)       # [B, 4, 2] corner deltas

The artifact is the predict chain (``AssembledModel.predict_delta``: the
backbone, then DSAC, RANSAC or the regressed deltas) on NHWC float32
patches, with the weights held in it. It is exported for one device
(JAX's ``platforms`` become ``device``): on the card its PF head is the
registered op ``bihome::pf_head_fwd``, whose CUDA implementation is K1
(``ops/fused_head.py``; ``torch.export`` cannot trace the kernel's ctypes
launch, so the op stands in the graph as one node); on the CPU the same
op runs the plain version. Loading needs ``bihome_torch.ops.fused_head``
imported, to register the op, and nothing else of the framework's state.

Determinism: the DSAC uniforms and the RANSAC point indices cannot come
from a ``torch.Generator`` inside an exported graph, so they are drawn
once, when the serving module is made, from ``rng_seed`` (JAX serves
under a fixed PRNGKey too), as a table of rows; a call of batch b takes
its first b rows. The live module and the artifact use the same table,
so they agree, and two calls on one input give the same bits (both run
under cuDNN's deterministic algorithms, :func:`deterministic`). A
batch-polymorphic artifact (``batch_size`` a name, e.g. ``'b'``) takes
any batch from 1 to ``MAX_BATCH``, the table's rows.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Tuple, Union

import torch
from torch import nn

from bihome_torch import geometry
from bihome_torch.heads import ransac
from bihome_torch.heads.assembled import needs_dsac, needs_ransac
from bihome_torch.ops import fused_head  # noqa: F401  (registers the op)

Tensor = torch.Tensor
MAX_BATCH = 1024


def serving_draws(model: nn.Module, rows: int, patch_size: int,
                  rng_seed: int = 0) -> Dict[str, Tensor]:
    """The predict chain's draws for ``rows`` samples, from ``rng_seed``:
    ``u12`` (and ``u21`` with DSAC_PREDICT_BIDIRECTIONAL) [rows, n * points
    per hypothesis] DSAC uniforms, or ``idx`` [rows, 4K] RANSAC point
    indices; none for a head that draws nothing."""
    head = model.head
    gen = torch.Generator().manual_seed(rng_seed)
    if needs_ransac(head):
        return {'idx': ransac.draw_indices(rows, patch_size * patch_size,
                                           ransac.NUM_HYPOTHESES, gen)}
    if not needs_dsac(head):
        return {}
    if head.dsac_point_sampling != 'reference-weighted':
        raise NotImplementedError(
            f'DSAC_POINT_SAMPLING {head.dsac_point_sampling!r} draws '
            'integers in the graph; only reference-weighted is exported')
    k = head.hypothesis_no * head.points_per_hypothesis
    draws = {'u12': torch.rand((rows, k), generator=gen)}
    if head.dsac_predict_bidirectional and len(head.pf_keys) > 1:
        draws['u21'] = torch.rand((rows, k), generator=gen)
    return draws


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, full float32 (no TF32), for the
    duration: without them a transposed convolution (the decoder's fused
    upsampling, cuDNN's backward-data algorithms) may sum in another
    order on each call. Restores the settings after."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class ServingModule(nn.Module):
    """``(patch_1, patch_2)`` NHWC float32 [B,ps,ps,C] -> delta_hat
    [B,4,2], the corners fixed to the patch frame (delta_hat does not
    depend on where the patch sat in its image); the draws are buffers
    (:func:`serving_draws`), sliced to the batch."""

    def __init__(self, model: nn.Module, patch_size: int,
                 draws: Dict[str, Tensor]):
        super().__init__()
        self.model = model.eval()
        self.patch_size = patch_size
        self.draw_names = tuple(draws)
        for name, value in draws.items():
            self.register_buffer(name, value)

    def forward(self, patch_1: Tensor, patch_2: Tensor) -> Tensor:
        b, ps = patch_1.shape[0], self.patch_size
        corners = geometry.image_corners(ps, ps, batch_size=b,
                                         device=patch_1.device)
        batch = {'patch_1': patch_1, 'patch_2': patch_2, 'corners': corners}
        draws = {name: getattr(self, name)[:b] for name in self.draw_names}
        uniforms = [draws[k] for k in ('u12', 'u21') if k in draws] or None
        with torch.no_grad(), deterministic():
            delta = self.model.predict_delta(batch, uniforms=uniforms,
                                             idx=draws.get('idx'))
        return delta.reshape(b, 4, 2)


def _symbolic(batch_size: Union[int, str]) -> bool:
    return isinstance(batch_size, str)


def make_serving_fn(built, model: nn.Module, batch_size: Union[int, str],
                    rng_seed: int = 0
                    ) -> Tuple[ServingModule, Tuple[Tuple, Tuple]]:
    """The live serving function over ``model`` (built by ``built``'s
    config) and the input shapes, (B, ps, ps, C) twice with B the batch or
    the dimension's name. Its draws have ``batch_size`` rows, or
    MAX_BATCH for a named (batch-polymorphic) dimension."""
    ps = built.test_pair_spec.patch_size
    channels = 1 if built.test_pair_spec.grayscale_keys else 3
    rows = MAX_BATCH if _symbolic(batch_size) else batch_size
    param = next(model.parameters())
    draws = {k: v.to(param.device)
             for k, v in serving_draws(model, rows, ps, rng_seed).items()}
    shape = (batch_size, ps, ps, channels)
    return ServingModule(model, ps, draws), (shape, shape)


def export_predict(built, model: nn.Module,
                   batch_size: Union[int, str] = 1, device='cpu',
                   rng_seed: int = 0) -> torch.export.ExportedProgram:
    """``torch.export`` of :func:`make_serving_fn` on ``device`` with a
    copy of the weights held in the program (later changes to ``model``
    do not reach it). ``batch_size`` a name exports one program for any
    batch from 1 to MAX_BATCH (``torch.export.Dim``)."""
    device = torch.device(device)
    live = copy.deepcopy(model).to(device).eval()
    module, (shape, _) = make_serving_fn(built, live, batch_size, rng_seed)
    symbolic = _symbolic(batch_size)
    # Two tensors: one passed twice would be traced as one input.
    examples = tuple(torch.zeros((2 if symbolic else batch_size,)
                                 + tuple(shape[1:]), device=device)
                     for _ in range(2))
    dynamic = None
    if symbolic:
        dim = torch.export.Dim(batch_size, min=1, max=MAX_BATCH)
        dynamic = ({0: dim}, {0: dim})
    with torch.no_grad():
        return torch.export.export(module, examples, dynamic_shapes=dynamic)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


class _Served(nn.Module):
    """An exported program's module, called under :func:`deterministic`;
    ``device`` is the one it was exported for."""

    def __init__(self, exported: torch.export.ExportedProgram):
        super().__init__()
        self.module = exported.module().requires_grad_(False)
        self.device = exported_device(exported)

    def forward(self, patch_1: Tensor, patch_2: Tensor) -> Tensor:
        with deterministic():
            return self.module(patch_1, patch_2)


def load_exported(path: str) -> nn.Module:
    """A saved artifact as a callable ``(patch_1, patch_2) -> delta_hat``,
    on the device it was exported for (its weights take no gradient),
    each call under :func:`deterministic`: two calls on one input give
    the same bits."""
    return _Served(torch.export.load(path))


def exported_input_shapes(path: str) -> Tuple[Tuple, ...]:
    """An artifact's input shapes, without running it; a symbolic
    (batch-polymorphic) dimension as a string, its symbol."""
    exported = torch.export.load(path)
    nodes = {n.name: n for n in exported.graph.nodes if n.op == 'placeholder'}
    shapes = []
    for name in exported.graph_signature.user_inputs:
        dims = nodes[name].meta['val'].shape
        shapes.append(tuple(int(d) if isinstance(d, int) or
                            str(d).isdigit() else str(d) for d in dims))
    return tuple(shapes)


def exported_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device an artifact was exported for (its weights')."""
    for value in exported.state_dict.values():
        return value.device
    return torch.device('cpu')


def graph_ops(exported: torch.export.ExportedProgram):
    """The names of the operators an artifact's graph calls."""
    return sorted({str(n.target) for n in exported.graph.nodes
                   if n.op == 'call_function'})
