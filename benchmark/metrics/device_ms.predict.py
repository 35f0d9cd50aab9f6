"""device_ms.predict: the device's busy ms a call in the traced calls."""


def read(ctx):
    t = ctx.get('trace')
    if 'calls' in ctx and t:
        return 1e3 * t['busy_s'] / t['units']
    return None
