"""Device composite: device milliseconds a frame of the export post,
between two CUDA timing events around it on the render stream (the
program's ``render.post.device`` span, recorded only in a traced run)."""


def read(ctx):
    total, count = ctx['report'].get('render.post.device', (0.0, 0))
    if not count or not ctx['frames']:
        return None
    return total * 1e3 / ctx['frames']
