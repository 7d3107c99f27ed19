"""Device: the share of the traced window in which no operation ran on
the device."""


def read(ctx):
    t = ctx['trace']
    if t is None or not t['device'] or not t['window_s']:
        return None
    return 1.0 - t['busy_s'] / t['window_s']
