"""Host planner: milliseconds a frame the calling thread waited inside
``next(batches)`` for the prepare thread's plan of a segment (the
program's ``render.prepare_wait`` span, ``profiling.report()``)."""


def read(ctx):
    total, count = ctx['report'].get('render.prepare_wait', (0.0, 0))
    if not count or not ctx['frames']:
        return None
    return total * 1e3 / ctx['frames']
