"""Kernels: the share of their byte roofline at which the render
kernels named in ``kernels/*.json`` ran over the window, in percent.

The floor is the least bytes each plan node carried by those kernels
moves (``bytes.segment_bytes``, from the node shapes that
``RenderPlanner.explain`` prints for each segment of a pass), times the
frames each of the window's batches rendered, over the published
bandwidth; the time is the sum of those kernels' durations in the device
trace. A node counts whatever kernel carries it, so the floor stays when
a kernel changes."""

import bisect
import re

from gpubench.metrics import bytes as kbytes


def _rendered(s0, s1, batch):
    """Frames a batch of segment [s0, s1) renders: the batch, its tail
    repeating the last frame, or a shorter segment's own length."""
    return batch if s1 - s0 >= batch else s1 - s0


def read(ctx):
    t = ctx['trace']
    if t is None or not t['device'] or ctx['plan_text'] is None:
        return None
    segs = kbytes.segment_bytes(ctx['plan_text'], ctx['kernels'])
    starts = [s0 for s0, _s1, _b in segs]
    total = 0
    for first in ctx['firsts']:
        i = bisect.bisect_right(starts, first) - 1
        if i < 0 or first >= segs[i][1]:
            return None
        s0, s1, per_frame = segs[i]
        total += (per_frame or 0) * _rendered(s0, s1, ctx['batch'])
    pats = [re.compile(r'\b%s\b' % re.escape(k['symbol']))
            for k in ctx['kernels']]
    spent_us = sum(b - a for name, a, b in t['device']
                   if any(p.search(name) for p in pats))
    if not total or not spent_us:
        return None
    return 100.0 * total / ctx['peak_bytes_per_s'] / (spent_us / 1e6)
