"""Shared graph-manager plumbing.

The video and audio space managers translate the same three geometry
edits (x, length, offset) into workspace updates plus dirty ranges; this
module holds that translation so both managers stay small.
"""

__all__ = ['apply_geometry_update', 'forward_stream_dirty',
           'GEOMETRY_KEYS']

#: SequenceItem.update kwargs that change rendered output. Both
#: sequence managers filter on this: the model also emits bare x=
#: cascade notifications for shifted followers, which the primary
#: edit's handling already covers.
GEOMETRY_KEYS = frozenset(('offset', 'source', 'length',
                           'transition_length'))


def forward_stream_dirty(notify, workspace_item, *args):
    """Rebase a source stream's ``frames_updated`` range into composite
    frames and re-fire it through *notify*.

    Streams fire ``(stream, lo, hi)``; nested graph managers fire
    ``(lo, hi)``; a ``None`` bound means unbounded. Composite frame
    ``f`` shows source frame ``f - x + offset``, so source frame ``s``
    surfaces at ``s + x - offset``; the result clips to the item's
    span. The reference never forwards these (its caches were cleared
    by any repaint), but the batched planner's RANGED invalidation
    relies on every content edit reaching the top-level signal.
    """
    lo, hi = args[-2], args[-1]
    x = workspace_item.x
    length = workspace_item.length
    offset = workspace_item.offset
    lo = x if lo is None else int(lo) + x - offset
    hi = x + length - 1 if hi is None else int(hi) + x - offset
    lo = max(lo, x)
    hi = min(hi, x + length - 1)
    if lo <= hi:
        notify(lo, hi)


def apply_geometry_update(workspace_item, notify, **kw):
    """Apply x/length/offset changes from a model item to its workspace
    item and report the invalidated coordinate ranges through *notify*.

    Three ranges can go stale (graph/video.py:56-64 in the reference):
    the leading edge sweep, the trailing edge sweep, and — when the
    source alignment (x - offset) changes — the whole overlap region.
    """
    before = (workspace_item.x, workspace_item.length,
              workspace_item.offset)
    after = (kw.get('x', before[0]), kw.get('length', before[1]),
             kw.get('offset', before[2]))
    if before == after:
        return

    workspace_item.update(x=after[0], length=after[1], offset=after[2])

    left_a, left_b = before[0], after[0]
    right_a = before[0] + before[1]
    right_b = after[0] + after[1]

    if left_a != left_b:
        notify(min(left_a, left_b), max(left_a, left_b) - 1)
    if right_a != right_b:
        notify(min(right_a, right_b), max(right_a, right_b) - 1)
    if before[0] - before[2] != after[0] - after[2]:
        notify(max(left_a, left_b), min(right_a, right_b) - 1)
