"""The planner's IR: ``Node`` trees, their signatures and flat params,
and the per-frame window algebra (the counterpart of
``canvas_tpu/render.py:52-217``).

A segment plans into one tree of ``Node`` objects. Its *signature* (op
names, static geometry, param shapes and dtypes) describes the
computation; its *flat params* (one dict per node, depth first) carry
the values. Params are NumPy arrays, or torch tensors for the stacks the
planner already staged on the device (``mesh.Replicated`` stacks when it
staged them onto a mesh); all take the same place in a signature (a
tensor's dtype is given NumPy's dtype number), so the signatures are
those of ``canvas_tpu.render`` for NumPy params.

Window metadata is array-form: a (B, 4) int64 ``[x0, y0, x1, y1]`` per
frame, an empty box encoded as max < min.
"""

import numpy as np
import torch

from canvas_tpu_torch.mesh import Replicated

__all__ = ['Node', 'signature', 'sliced_signature', 'flat_params',
           'windows_to_array', 'tile_window', 'rel_box_array']


class Node:
    """One IR node: a static signature + per-frame params + children.

    ``windows`` is host-side metadata: the per-frame current windows (the
    window algebra the pull path computes), used by parents for masking
    boxes and by the planner for the frame metadata. It is not part of
    the signature.
    """

    __slots__ = ('op', 'static', 'params', 'children', 'windows')

    def __init__(self, op, static=(), params=None, children=(), windows=None):
        self.op = op
        self.static = tuple(static)
        self.params = params if params is not None else {}
        self.children = list(children)
        self.windows = windows

    def signature(self):
        return sliced_signature(self, None, None)

    def flat_params(self, out):
        """Depth-first parameter collection, the order the evaluator
        visits nodes in (``flat_params``)."""
        return flat_params(self, out)

    def flat_ops(self, out):
        """Node op names in the same depth-first order as flat_params."""
        out.append(self.op)
        for c in self.children:
            c.flat_ops(out)
        return out


# Ops whose per-frame parameter axis is NOT the leading one.
# 'solid_stack' params are (L, B, ...): layers lead, frames second.
_BATCH_AXIS = {'solid_stack': 1}

# Which params of each op carry the frame (batch) axis. Slicing consults
# THIS, never shape coincidence, so a replicated param whose dim happens
# to equal the segment length (a (3, 3) color matrix over a 3-frame
# segment) is never sliced per frame. Every op the port's emitters
# produce has an entry.
_FRAME_PARAMS = {
    'solid': frozenset(('color', 'box')),
    'stage': frozenset(('data',)),
    'stage_rows': frozenset(('rows',)),
    'solid_stack': frozenset(('color', 'box', 'gain', 'offset')),
    'empty': frozenset(),
    'placed': frozenset(),
    'gain_offset': frozenset(('gain', 'offset', 'box')),
    'mix': frozenset(('mix_b',)),
    'over_stack': frozenset(),
    'scale': frozenset(),               # wy/wx shared across the segment
    'scale_taps_dyn': frozenset(('fy', 'fx', 'tpy', 'tpx', 'spy', 'spx',
                                 'yl', 'yh', 'xl', 'xh')),
    # Factored scaled solid: ry/rx shared (static taps) or rebuilt per
    # frame from the same scalars as scale_taps_dyn.
    'scale_solid': frozenset(('color',)),
    'scale_solid_dyn': frozenset(('fy', 'fx', 'tpy', 'tpx', 'spy', 'spx',
                                  'yl', 'yh', 'xl', 'xh', 'color')),
    'place': frozenset(),
    'transfer': frozenset(),
    'matrix': frozenset(),
    'u8_linearize': frozenset(('data',)),
    'dv_recon': frozenset(('y', 'cb', 'cr')),
    'dv_recon_rows': frozenset(('rows',)),
    'planar_recon_rows': frozenset(('rows',)),
    'field_interleave': frozenset(('start_y', 'end_y', 'x0', 'x1')),
}


def _frame_params(op):
    try:
        return _FRAME_PARAMS[op]
    except KeyError:
        raise ValueError('op %r has no _FRAME_PARAMS declaration' % (op,))


def _dtype_num(v):
    """NumPy dtype number of a param: torch tensors map their dtype to
    NumPy's; anything else as ``canvas_tpu``'s ``Node.signature`` reads
    it."""
    if isinstance(v, (torch.Tensor, Replicated)):
        return torch.empty((), dtype=v.dtype).numpy().dtype.num
    return np.dtype(getattr(v, 'dtype', None) or np.asarray(v).dtype).num


def sliced_signature(node, N, B):
    """The signature of *node* after its frame axes are cut from N to B
    frames (``canvas_tpu.render._sliced_signature``, render.py:1270-1299):
    which params carry a frame axis is declared per op
    (``_FRAME_PARAMS``), at the op's ``_BATCH_AXIS``; 'empty' carries its
    batch size in static. ``N=None`` cuts nothing (``Node.signature``)."""
    child_sigs = tuple(sliced_signature(c, N, B) for c in node.children)
    ax = _BATCH_AXIS.get(node.op, 0)
    fp = _frame_params(node.op) if N is not None else ()
    shapes = []
    for k, v in node.params.items():
        shp = (tuple(v.shape) if isinstance(v, (torch.Tensor, Replicated))
               else np.shape(v))
        if k in fp:
            if len(shp) <= ax or shp[ax] != N:
                raise ValueError(
                    'op %r frame param %r has shape %r; expected axis %d '
                    'of length %d' % (node.op, k, shp, ax, N))
            shp = shp[:ax] + (B,) + shp[ax + 1:]
        shapes.append((k, shp, _dtype_num(v)))
    static = node.static
    if node.op == 'empty' and N is not None:
        if static[0] != N:
            raise ValueError("'empty' static batch %r != segment length %d"
                             % (static[0], N))
        static = (B,) + static[1:]
    return (node.op, static, tuple(sorted(shapes)), child_sigs)


def signature(node):
    """``node.signature()``: the structure signature, nothing cut."""
    return sliced_signature(node, None, None)


def flat_params(node, out=None):
    """Each node's params, depth first, the order the evaluator visits
    them in. Torch tensors and ``Replicated`` stacks (already on the
    device) pass through untouched; anything else becomes a NumPy
    array."""
    out = [] if out is None else out
    out.append({k: (v if isinstance(v, (torch.Tensor, Replicated))
                    else np.asarray(v))
                for k, v in node.params.items()})
    for c in node.children:
        flat_params(c, out)
    return out


def windows_to_array(windows):
    """Windows -> (B, 4) int64 [x0, y0, x1, y1] (empty boxes keep their
    max<min encoding). Accepts an array (returned as-is) or a list of
    box2i."""
    if isinstance(windows, np.ndarray):
        return windows
    out = np.empty((len(windows), 4), np.int64)
    for i, w in enumerate(windows):
        mn, mx = w
        out[i, 0] = mn[0]
        out[i, 1] = mn[1]
        out[i, 2] = mx[0]
        out[i, 3] = mx[1]
    return out


def tile_window(window, count):
    """(B, 4) array repeating one box2i (or EMPTY when it's empty)."""
    if window.empty():
        row = np.asarray([0, 0, -1, -1], np.int64)
    else:
        row = np.asarray([window.min.x, window.min.y,
                          window.max.x, window.max.y], np.int64)
    return np.tile(row, (count, 1))


def rel_box_array(windows, full):
    """Windows (list of box2i or (B,4) array) -> (B, 4) int32
    [y0, y1, x0, x1] relative to *full*, clipped; empty -> (0,-1,0,-1)."""
    arr = windows_to_array(windows)
    lo = np.asarray([full.min.x, full.min.y], np.int64)
    hi = np.asarray([full.max.x, full.max.y], np.int64)
    org = np.asarray([full.min.x, full.min.y, full.min.x, full.min.y],
                     np.int64)
    clip = np.concatenate([np.maximum(arr[:, :2], lo),
                           np.minimum(arr[:, 2:], hi)], axis=1) - org
    empty = (clip[:, 2] < clip[:, 0]) | (clip[:, 3] < clip[:, 1])
    out = clip[:, (1, 3, 0, 2)].astype(np.int32)
    out[empty] = (0, -1, 0, -1)
    return out

