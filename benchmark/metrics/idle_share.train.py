"""idle_share.train: 1 - the union of the device's busy intervals over the
traced block's host seconds, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx) if 'steps' in ctx else None
