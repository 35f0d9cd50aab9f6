"""datagen_ms.train: ms a step from the pool draw to the backbone's
forward: the pool gather and the pair synthesis (CUDA events)."""

from benchmark.harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, 'start-fwd0') if 'steps' in ctx else None
