"""Export stream: milliseconds a frame the calling thread waited in
``backend.to_host`` (the benchmark's own span around each fetch)."""


def read(ctx):
    if not ctx['fetch'] or not ctx['frames']:
        return None
    return ctx['fetch_s'] * 1e3 / ctx['frames']
