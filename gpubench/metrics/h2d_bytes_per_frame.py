"""Staging: host-to-device bytes a frame (``backend.transfer_stats``
over the window: staged planes and packed params)."""


def read(ctx):
    if not ctx['h2d_calls'] or not ctx['frames']:
        return None
    return ctx['h2d_bytes'] / ctx['frames']
