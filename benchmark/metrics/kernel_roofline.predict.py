"""kernel_roofline.predict: the same over a serving call's kernels, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.kernel_roofline(ctx) if 'calls' in ctx else None
