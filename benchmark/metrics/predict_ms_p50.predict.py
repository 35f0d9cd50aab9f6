"""predict_ms_p50.predict: the median call's latency in the window (nearest
rank), in ms."""

from benchmark.harness import readers


def read(ctx):
    if 'calls' in ctx:
        return 1e3 * readers.percentile(ctx['latencies_s'], 50)
    return None
