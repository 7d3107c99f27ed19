"""The least bytes a frame's render kernels move, from the plan's node
shapes (PERF.md's per-kernel counts, NVIDIA H100 rows):

- ``solid_stack`` (``solid_fold``): 16 B/px to write the f32 (P, A)
  accumulators, 16 B/px more to read them where a layer under it left
  some; the root's last one writes 8 B/px of f16 frame in their place
  (a finalize: 24 B/px over a base);
- ``placed`` over a ``scale_solid`` or ``scale_solid_dyn``
  (``region_over_sep``): 32 B/px of the region, the accumulators read
  and written;
- any other ``placed`` (``region_over``): 48 B/px of the region, the f32
  layer read besides.

The shapes come from ``RenderPlanner.explain``: a line a segment, then
one line a node, two spaces of indent a level, the root one level in."""

import ast
import re

_STATIC = re.compile(r'static=(\([^)]*\))')
_SEGMENT = re.compile(r'segment \[(-?\d+), (-?\d+)\)')


def _segments(plan_text):
    """``(s0, s1, nodes)`` of each segment of the report, *nodes* the
    ``(depth, op, static)`` of its tree's nodes."""
    out = []
    for line in plan_text.splitlines():
        m = _SEGMENT.match(line)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), []))
            continue
        if not out or not line.startswith('  '):
            continue
        body = line.lstrip(' ')
        depth = (len(line) - len(body)) // 2 - 1
        m = _STATIC.search(body)
        static = ast.literal_eval(m.group(1)) if m else ()
        out[-1][2].append((depth, body.split()[0], static))
    return out


def _node_bytes(nodes, named):
    """Bytes a frame of one segment's tree for the kernels *named*, or
    None when its root is not an ``over_stack``."""
    if not nodes or nodes[0][1] != 'over_stack':
        return None
    H, W = nodes[0][2][0], nodes[0][2][1]
    children = [i for i, n in enumerate(nodes) if n[0] == 1]
    total = 0
    for pos, i in enumerate(children):
        _d, op, static = nodes[i]
        below = pos > 0
        if op == 'solid_stack' and 'solid_fold' in named:
            if pos == len(children) - 1:
                total += H * W * ((16 if below else 0) + 8)
            else:
                total += H * W * ((16 if below else 0) + 16)
        elif op == 'placed':
            inner = nodes[i + 1][1] if i + 1 < len(nodes) else None
            h, w = static[0], static[1]
            if inner in ('scale_solid', 'scale_solid_dyn'):
                if 'region_over_sep' in named:
                    total += h * w * 32
            elif 'region_over' in named:
                total += h * w * 48
    return total


def segment_bytes(plan_text, kernels):
    """``(s0, s1, bytes a frame)`` of each segment of *plan_text* for the
    kernels named in *kernels* (the dicts of ``kernels/*.json``); the
    bytes are None where the segment's root is not an ``over_stack``."""
    named = {k['name'] for k in kernels}
    return [(s0, s1, _node_bytes(nodes, named))
            for s0, s1, nodes in _segments(plan_text)]


def frame_bytes(plan_text, kernels):
    """Bytes a frame of the report's first segment (``segment_bytes``),
    or None."""
    segs = segment_bytes(plan_text, kernels)
    return segs[0][2] if segs else None
