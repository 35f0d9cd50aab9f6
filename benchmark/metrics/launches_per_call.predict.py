"""launches_per_call.predict: kernels launched in the traced calls over
their number."""

from benchmark.harness import readers


def read(ctx):
    return readers.launches_per_unit(ctx) if 'calls' in ctx else None
