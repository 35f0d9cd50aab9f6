"""mfu.train: the reference step's counted operations
(benchmark/counts/flops.py) times the window's steps over its seconds,
as a share of the TF32 peak, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu(ctx, 'step_flops', 'steps')
