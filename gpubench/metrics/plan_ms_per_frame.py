"""Host planner: milliseconds a frame in the program's ``render.plan``
span (``profiling.report()``) over the window, on the prepare thread."""


def read(ctx):
    total, count = ctx['report'].get('render.plan', (0.0, 0))
    if not count or not ctx['frames']:
        return None
    return total * 1e3 / ctx['frames']
