"""backbone_ms.predict: ms a call in the backbone's forward (CUDA events)."""

from benchmark.harness import readers


def read(ctx):
    return readers.per_unit_ms(ctx, 'fwd0-fwd1') if 'calls' in ctx else None
