"""Staging: milliseconds a frame the prepare thread spent staging coded
planes (``coded.device_plane_stack``: the DV planes pulled and copied to
the card; the program's ``render.stage.coded`` span, inside
``render.plan``)."""


def read(ctx):
    total, count = ctx['report'].get('render.stage.coded', (0.0, 0))
    if not count or not ctx['frames']:
        return None
    return total * 1e3 / ctx['frames']
