"""optimizer_ms.train: ms a step from the optimizer's gradient norm to the
end of its update (CUDA events)."""

from benchmark.harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, 'bwd1-opt1') if 'steps' in ctx else None
