"""backbone_ms.train: ms a step in the backbone's forward and its backward,
from its outputs' gradients to the optimizer's gradient norm (CUDA
events)."""

from benchmark.harness import readers


def read(ctx):
    if 'steps' in ctx:
        return readers.per_unit_ms(ctx, 'fwd0-fwd1', 'head1-bwd1')
    return None
