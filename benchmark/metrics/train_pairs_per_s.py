"""train_pairs_per_s: the pairs of every step the window completed over the
window's seconds, which end at the last block's synchronize."""


def read(ctx):
    return ctx['pairs'] / ctx['window_s'] if 'steps' in ctx else None
