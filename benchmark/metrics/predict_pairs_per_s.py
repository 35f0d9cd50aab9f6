"""predict_pairs_per_s: the pairs of every call the window answered over
the window's seconds."""


def read(ctx):
    return ctx['pairs'] / ctx['window_s'] if 'calls' in ctx else None
