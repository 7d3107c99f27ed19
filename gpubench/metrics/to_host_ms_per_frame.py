"""Export stream: milliseconds a frame in ``backend.to_host``, the
pinned fetch of each batch (the program's own ``backend.to_host`` span,
``profiling.report()``)."""


def read(ctx):
    total, count = ctx['report'].get('backend.to_host', (0.0, 0))
    if not count or not ctx['frames']:
        return None
    return total * 1e3 / ctx['frames']
