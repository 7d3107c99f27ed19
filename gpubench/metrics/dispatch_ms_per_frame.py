"""Program cache: milliseconds a frame the calling thread spent taking
each segment's render program and calling it for each batch (bind,
replay and the post's enqueue; the program's ``render.dispatch`` span,
``profiling.report()``)."""


def read(ctx):
    total, count = ctx['report'].get('render.dispatch', (0.0, 0))
    if not count or not ctx['frames']:
        return None
    return total * 1e3 / ctx['frames']
