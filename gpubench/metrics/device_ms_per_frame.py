"""Device composite: device busy milliseconds a frame, busy being the
union of the device's kernel, copy and set intervals in the trace of
the window."""


def read(ctx):
    t = ctx['trace']
    if t is None or not t['device'] or not ctx['frames']:
        return None
    return t['busy_s'] * 1e3 / ctx['frames']
