"""predict_ms_p95: the nearest-rank 95th percentile of every call's latency
in the window, from send to delta_hat on the host, in ms."""

from benchmark.harness import readers


def read(ctx):
    if 'calls' in ctx:
        return 1e3 * readers.percentile(ctx['latencies_s'], 95)
    return None
