"""head_ms.predict: ms a call from the backbone's outputs to delta_hat: the
DSAC fit (CUDA events)."""

from benchmark.harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, 'fwd1-end') if 'calls' in ctx else None
