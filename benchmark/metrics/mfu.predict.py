"""mfu.predict: the reference call's counted operations times the window's
calls over its seconds, as a share of the TF32 peak, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu(ctx, 'call_flops', 'calls')
