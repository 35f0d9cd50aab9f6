"""device_ms.train: the device's busy ms a step in the traced block (the
union of its busy intervals over the block's steps): the device work a
step needs, steadier than the rate, which the host's speed moves."""


def read(ctx):
    t = ctx.get('trace')
    if 'steps' in ctx and t:
        return 1e3 * t['busy_s'] / t['units']
    return None
