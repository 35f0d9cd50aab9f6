"""idle_share.predict: the same over the traced calls, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx) if 'calls' in ctx else None
