"""launches_per_step.train: kernels launched in the traced block over its
steps."""

from benchmark.harness import readers


def read(ctx):
    return readers.launches_per_unit(ctx) if 'steps' in ctx else None
