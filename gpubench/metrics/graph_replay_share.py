"""Program cache: the share of the window's program calls that replayed
a captured CUDA graph (``render.program_stats()``)."""


def read(ctx):
    calls = ctx['programs']['calls']
    if not calls:
        return None
    return ctx['programs']['replays'] / calls
