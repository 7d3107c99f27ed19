"""Batched rendering on PyTorch: the counterpart of
``canvas_tpu/render.py``.

Sources plan a frame range on the host into a ``Node`` tree
(``canvas_tpu_torch.ir``) through the port's ``PlanContext``
(``plan.py``, which stages host-pulled frames and coded planes onto the
device itself); the tree's signature plus its flat parameter list
describe the whole computation. This module evaluates that signature
with torch ops and the port's CUDA kernels, and ``RenderPlanner``
streams frame ranges through it. Nothing here touches JAX.

The slice covers the ops of the headline composite
(``timelines.build_timeline``) and of the mixed-content timeline
(``timelines.mixed_timeline``: DV clips through animated scalers):
``solid``, ``empty``, ``gain_offset``, ``mix``, ``solid_stack``,
``over_stack`` (f32 accumulators at quality 10, the bf16 ``acc16``
accumulators at quality <= 9), ``placed`` (rank-1 regions through
``region_over_sep``, any other region through ``region_over``),
``scale_solid``, ``scale_solid_dyn``, ``scale``, ``scale_taps_dyn``
(with the quality <= 5 ``lq`` taps), ``place``, ``stage``,
``stage_rows``, ``dv_recon``, ``dv_recon_rows``, the generic planar
``planar_recon_rows``, the pulldown filter's ``field_interleave``, and
the color filter's ``transfer`` and ``matrix``; the export conversions of
``iter_batches(post=...)``; and the editor's display pull,
``render_display``, with its viewport resample and its u8, rgb24 and
yuv420 transports. Every other op raises ``NotImplementedError`` naming
the ROADMAP.md queue item that ports it.

``RenderPlanner.iter_batches`` keeps prepared segments (the plan cut into
batches, their params on the device once dispatched) in a plan cache, so
a replayed range plans nothing and copies nothing; ``max_inflight``
bounds how far the host runs ahead of the device, and a pre-flight
estimate refuses a batch that cannot fit the card's memory.

Render programs (render.py:1302-1503, 2183-2217): as the JAX package
compiles one ``jax.jit`` program per structure signature and replays it
for every batch, segment and pass, the port captures the evaluation of
a signature once as ONE CUDA graph on its card (``_get_program``,
``_Program``; at its second batch, the first two running eagerly) and
replays it: a batch then costs one packed param copy, one graph replay
and a short eager finish (the op that writes the returned frames, into
memory the caller owns), not ~130 launches from Python. The region
kernels read their offsets from the param buffer, so one graph serves
every position of an animated region. ``render``, ``iter_batches``
(unsharded and per shard), ``render_display`` and the tail batch each
take their program; the memory guard counts the programs' pools and
evicts the least recently used (``_make_room``). On the CPU a program
runs the same binding, body and finish eagerly.

Multi-device (render.py:1750-2042, 2392-2460): ``iter_batches(mesh=,
axis=)`` splits each batch's frames over one axis of a ``mesh.Mesh``
and renders each shard on its own device, and ``render_sharded`` is the
frame-parallel collector over it, with an optional row reshard over a
second mesh axis. The JAX package compiles one sharded program per
signature (``_get_sharded_program``) and commits the replicated params
to the mesh (``_commit_replicated_params``); the port takes one program
per (shard signature, device), so a mesh that names a card twice
replays that card's program once per shard, and keeps the placement: a
param an op declares per frame splits, every other is replicated
(``_param_sharding``), and each shard's params go to its device in one
packed copy (``params_to_shards``).
"""

import contextlib
import functools
import gc
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from canvas_tpu_torch import backend, profiling
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ir import (  # noqa: F401 (Node: the public name)
    _BATCH_AXIS, Node, _frame_params, flat_params, signature,
    sliced_signature, windows_to_array)
from canvas_tpu_torch.mesh import (Mesh, Replicated, ShardedFrames,
                                   Sharding, local_mesh)
from canvas_tpu_torch.ops import chroma as chroma_ops
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.ops import cuda_ops
from canvas_tpu_torch.ops import scale as scale_ops
from canvas_tpu_torch.plan import PlanContext, StageLRU

__all__ = ['RenderPlanner', 'render_frames', 'render_sharded', 'Node',
           'box2i', 'check_placed', 'display_matrices_host', 'flat_params',
           'params_to_shards', 'params_to_torch', 'program_stats', 'run',
           'signature', 'sliced_signature']

#: The transports of ``RenderPlanner.render_display``.
DISPLAY_TRANSPORTS = ('u8', 'rgb24', 'yuv420')

#: Viewport sizes whose device resample matrices a planner keeps.
_DISPLAY_MATS_KEPT = 8

#: Ops of the IR that the port does not evaluate, with the ROADMAP.md
#: queue-1 item that says why; the port has no source that plans them.
_LATER = {
    'solid_cells': 'queue 1 item 9 (not ported)',
}

_log = logging.getLogger('canvas_tpu_torch.render')


def _not_ported(what, item):
    return NotImplementedError('%s is not ported to canvas_tpu_torch yet '
                               '(ROADMAP.md %s)' % (what, item))


def _canonical(v):
    """JAX's x64-off canonicalisation of a host param: float64 -> f32,
    int64 -> i32, so both evaluators see the same dtypes."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _leaf_layout(plist):
    """The packed layout of a flat param list's host leaves:
    ``([(i, key, flat array, shape, offset)], size)``, node by node and
    within a node by sorted key, each leaf at a multiple of 16 bytes, in
    the dtype both evaluators see (``_canonical``). Tensors already on
    the device pass through and take no place. A signature fixes the
    layout of the lists it has host leaves at the same places for."""
    leaves, size = [], 0
    for i, p in enumerate(plist):
        for k in sorted(p):
            v = p[k]
            if isinstance(v, torch.Tensor):
                continue
            a = _canonical(v)
            # (ascontiguousarray would make a 0-d leaf 1-d)
            leaves.append((i, k, np.ascontiguousarray(a).reshape(-1),
                           a.shape, size))
            size += -(-a.nbytes // 16) * 16
    return leaves, size


def _leaf_key(leaves):
    """What two layouts must share for one packed buffer to fill the
    other's: each leaf's place, dtype, shape and offset."""
    return tuple((i, k, a.dtype.str, shape, off)
                 for i, k, a, shape, off in leaves)


def _pack(leaves, size, pinned):
    """The host leaves in one uint8 tensor of *size* bytes (pinned memory
    for a copy to a card)."""
    host = torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
    flat = host.numpy()
    for _i, _k, a, _shape, off in leaves:
        flat[off:off + a.nbytes] = a.view(np.uint8)
    return host


def _leaf_view(buffer, dtype_str, shape, off):
    """The tensor of one leaf: a view of its bytes in *buffer*."""
    dtype = torch.from_numpy(np.empty(0, dtype_str)).dtype
    nbytes = np.dtype(dtype_str).itemsize * int(np.prod(shape,
                                                       dtype=np.int64))
    return buffer[off:off + nbytes].view(dtype).reshape(shape)


class _DeviceParams(list):
    """A flat param list on the device (``params_to_torch``): the node
    dicts, plus the one buffer that holds every host leaf (``buffer``)
    and that buffer's layout (``leaf_key``), so a render program with the
    same layout takes all the leaves in one device copy."""

    __slots__ = ('buffer', 'leaf_key')


def params_to_torch(plist, device):
    """The planner's flat param list (one dict per node, depth first; the
    same list ``Node.flat_params`` gives ``canvas_tpu.render._eval``) as
    tensors on *device*, uploaded in ONE copy: every host leaf packed
    into one buffer (``_leaf_layout``: leaves start at multiples of 16
    bytes), the buffer copied, and each leaf a tensor that views its
    bytes there. Some thirty small arrays per batch would else each cost
    a copy of their own. The region offsets ``dy0``/``dx0`` are leaves
    like any other (int32 tensors of one value, which the region kernels
    read on the device; ``check_placed`` checked them on the host).
    Tensors already made by the planner (the staged stacks, on *device*)
    pass through. On CUDA the bytes go from pinned memory with
    ``non_blocking=True`` on the current stream, and the copy is counted
    in ``backend.transfer_stats``. Returns a ``_DeviceParams``."""
    leaves, size = _leaf_layout(plist)
    cuda = device.type == 'cuda'
    host = _pack(leaves, size, cuda)
    if cuda:
        buffer = host.to(device, non_blocking=True)
        backend.count_h2d(size, 1)
    else:
        buffer = host
    out = _DeviceParams(dict(p) for p in plist)
    for i, k, a, shape, off in leaves:
        out[i][k] = _leaf_view(buffer, a.dtype.str, shape, off)
    out.buffer = buffer
    out.leaf_key = _leaf_key(leaves)
    return out


def check_placed(node):
    """Check every region offset of a planned tree on the host, before
    its params go to the device (the planner's region quantization,
    sources.py): a ``placed`` layer of an ``over_stack`` of (H, W) frames
    is whole (64, 128) blocks, at block-aligned offsets, inside the
    frame's (64, 128) envelope (``cuda_ops.check_offsets``). The region
    kernels read the offsets from device memory and cannot check them.
    Returns *node*."""
    stack = [node]
    while stack:
        n = stack.pop()
        if n.op == 'over_stack':
            H, W = n.static[0], n.static[1]
            for c in n.children:
                if c.op == 'placed':
                    h, w = c.static
                    cuda_ops._check_region('placed', h, w)
                    cuda_ops.check_offsets('placed', c.params['dy0'],
                                           c.params['dx0'], h, w, H, W)
        stack.extend(n.children)
    return node


def _param_sharding(op, key):
    """The ONE rule for how a param shards over a mesh
    (``canvas_tpu.render._param_sharding``, render.py:1353-1380): a param
    its op declares per frame (``_frame_params``) splits along the op's
    batch axis (``_BATCH_AXIS``); every other param is replicated. Returns
    that axis, or None for a replicated param. Batch cutting, shard
    splitting and the display pull's frame slice all ask this, never a
    shape that happens to match."""
    if key in _frame_params(op):
        return _BATCH_AXIS.get(op, 0)
    return None


def _on(device):
    """``torch.cuda.device(device)`` on a card (launches, the current
    stream, the allocator and events then agree on it), nothing on the
    CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _split_shards(plist, ops, devices):
    """One batch's flat param list (*ops* its nodes' ops, depth first)
    split over ``len(devices)`` frame shards, still on the host: shard j
    takes frames [j*b, (j+1)*b) of every param ``_param_sharding``
    splits, and every replicated param whole (a ``mesh.Replicated``
    stack as its copy on the shard's device)."""
    n = len(devices)
    out = []
    for j, device in enumerate(devices):
        shard = []
        for p, op in zip(plist, ops):
            q = {}
            for k, v in p.items():
                if isinstance(v, Replicated):
                    v = v.on(device)
                ax = _param_sharding(op, k)
                if ax is not None:
                    b = v.shape[ax] // n
                    v = v[(slice(None),) * ax + (slice(j * b, (j + 1) * b),)]
                q[k] = v
            shard.append(q)
        out.append(shard)
    return out


def params_to_shards(plist, ops, devices):
    """One batch's flat param list split over ``len(devices)`` frame
    shards (``_split_shards``), each shard's list sent to its device in
    ONE packed copy (``params_to_torch``, on that device's current
    stream). Returns one tensor param list per shard."""
    out = []
    for device, shard in zip(devices, _split_shards(plist, ops, devices)):
        with _on(device):
            out.append(params_to_torch(shard, device))
    return out


def _box_mask(box, H, W):
    """(B, 1, H, W) mask of the inclusive per-frame boxes (B, 4)."""
    dev = box.device
    rows = torch.arange(H, dtype=torch.int32, device=dev).view(1, 1, H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, 1, W)
    b = box[:, :, None, None]
    return ((rows >= b[:, 0:1]) & (rows <= b[:, 1:2]) &
            (cols >= b[:, 2:3]) & (cols <= b[:, 3:4]))


def _dyn_axis_taps(fv, tp, sp, lo, hi, t_lo, T, K, lq, S=None):
    """Per-frame 1-D resample taps built on the device from scalar
    params, in the op order of render.py:749-777: ``(idx, w)`` with idx
    (B, T, K) int32 source positions clipped to [0, S-1] (None when S is
    None) and w (B, T, K) f32 weights (triangle filter, bilinear when
    *lq*, normalised when downscaling, zeroed outside the [lo, hi]
    source window)."""
    dev = fv.device
    t = torch.arange(T, dtype=torch.float32, device=dev).view(1, T) + t_lo
    f = fv[:, None]
    width = (torch.ones_like(f) if lq
             else torch.where(f > 1.0, 1.0, 1.0 / f))
    g = (t - tp[:, None]) / f + sp[:, None]
    left = torch.floor(g - width) + 1.0
    k = torch.arange(K, dtype=torch.float32, device=dev).view(1, 1, K)
    pos = left[:, :, None] + k
    dist = torch.abs(pos - g[:, :, None]) / width[:, :, None]
    w = torch.clamp_min(1.0 - dist, 0.0)
    sums = torch.sum(w, dim=2, keepdim=True)
    w = torch.where((f <= 1.0)[:, :, None] & (sums != 0.0),
                    w / torch.where(sums != 0.0, sums, 1.0), w)
    in_window = ((pos >= lo[:, None, None]) &
                 (pos <= hi[:, None, None]))
    w = torch.where(in_window, w, 0.0)
    idx = (torch.clamp(pos, 0, S - 1).to(torch.int32)
           if S is not None else None)
    return idx, w


def _scale_solid_factors(op, static, params):
    """(color (B, 4), ry (B, Ty), rx (B, Tx)) of a factored scaled solid,
    contiguous (render.py:965-984)."""
    color = params['color']
    B = color.shape[0]
    if op == 'scale_solid':
        ry = params['ry'][None, :].expand(B, -1).contiguous()
        rx = params['rx'][None, :].expand(B, -1).contiguous()
        return color, ry, rx
    (Ky, Kx, Ty, Tx, lq) = static
    _i, wy = _dyn_axis_taps(params['fy'], params['tpy'], params['spy'],
                            params['yl'], params['yh'], params['tly'], Ty,
                            Ky, lq)
    _i, wx = _dyn_axis_taps(params['fx'], params['tpx'], params['spx'],
                            params['xl'], params['xh'], params['tlx'], Tx,
                            Kx, lq)
    return color, torch.sum(wy, dim=2), torch.sum(wx, dim=2)


def _densify(idx, w, S):
    """Per-frame dense (B, T, S) resample matrices from K taps, the
    one-hot sum of render.py:1081-1085 (duplicate clipped indices add
    up, as the gather-add they stand for)."""
    s = torch.arange(S, dtype=torch.int32, device=idx.device)
    terms = torch.where(idx[:, :, :, None] == s, w[:, :, :, None], 0.0)
    return torch.sum(terms, dim=2)


def _tag_op(err, op):
    """Name on *err* the innermost op that raised it (a failed capture
    reports it), unless an op inside already did."""
    if getattr(err, 'canvas_op', None) is None:
        try:
            err.canvas_op = op
        except AttributeError:     # an exception type without a __dict__
            pass


def _eval(node_sig, params_iter, device, out_dtype=torch.float32):
    """Rebuild the computation from the structure signature on *device*,
    visiting nodes in the depth-first order of ``Node.flat_params``.
    Each op follows the matching branch of ``canvas_tpu.render._eval``
    (render.py:786-1127). An ``over_stack`` at the root whose last child
    is a solid run finalizes straight to *out_dtype*, which ``run`` sets
    to f16 (the root's f16 store folded into the kernel); everything else
    is f32. An exception names the op that raised it (``canvas_op``)."""
    try:
        return _eval_op(node_sig, params_iter, device, out_dtype)
    except Exception as err:
        _tag_op(err, node_sig[0])
        raise


def _eval_op(node_sig, params_iter, device, out_dtype):
    op, static, _, child_sigs = node_sig
    params = next(params_iter)

    if op == 'solid':
        H, W = static
        mask = _box_mask(params['box'], H, W)
        return torch.where(mask, params['color'][:, :, None, None], 0.0)

    if op == 'solid_stack':
        L, H, W = static
        return cuda_ops.solid_stack(params['color'], params['box'],
                                    params['gain'], params['offset'], H, W)

    if op == 'empty':
        B, H, W = static
        return torch.zeros((B, 4, H, W), dtype=torch.float32, device=device)

    if op == 'placed':
        raise ValueError("'placed' node outside over_stack")

    if op == 'gain_offset':
        child = _eval(child_sigs[0], params_iter, device)
        gain = params['gain'][:, None, None, None]
        offset = params['offset'][:, None, None, None]
        rgb = child[:, :3] * gain + offset
        mask = _box_mask(params['box'], child.shape[2], child.shape[3])
        rgb = torch.where(mask, rgb, 0.0)
        return torch.cat([rgb, child[:, 3:]], dim=1)

    if op == 'mix':
        a = _eval(child_sigs[0], params_iter, device)
        bb = _eval(child_sigs[1], params_iter, device)
        mix_b = torch.clamp(params['mix_b'], 0.0, 1.0)[:, None, None]
        alpha_a = a[:, 3] * (1.0 - mix_b)
        alpha_b = bb[:, 3] * mix_b
        out_a = alpha_a + alpha_b
        num = a[:, :3] * alpha_a[:, None] + bb[:, :3] * alpha_b[:, None]
        nz = out_a[:, None] != 0.0
        rgb = torch.where(nz, num / torch.where(nz, out_a[:, None], 1.0), 0.0)
        return torch.cat([rgb, out_a[:, None]], dim=1)

    if op == 'over_stack':
        return _over_stack(static, child_sigs, params_iter, device,
                           out_dtype)

    if op in ('scale_solid', 'scale_solid_dyn'):
        color, ry, rx = _scale_solid_factors(op, static, params)
        return (color[:, :, None, None] * ry[:, None, :, None]
                * rx[:, None, None, :])

    if op == 'stage':
        return params['data'].float()

    if op == 'stage_rows':
        # this batch's rows of the segment's staged (U, 4, H, W) f16 stack
        return torch.index_select(params['data'], 0,
                                  params['rows']).float()

    if op == 'dv_recon_rows':
        rows = params['rows']
        return chroma_ops.dv_recon_torch(
            torch.index_select(params['py'], 0, rows),
            torch.index_select(params['pcb'], 0, rows),
            torch.index_select(params['pcr'], 0, rows),
            params['up'], params['m'])

    if op == 'dv_recon':
        return chroma_ops.dv_recon_torch(params['y'], params['cb'],
                                         params['cr'], params['up'],
                                         params['m'])

    if op == 'planar_recon_rows':
        rows = params['rows']
        return chroma_ops.planar_recon_torch(
            torch.index_select(params['py'], 0, rows),
            torch.index_select(params['pcb'], 0, rows),
            torch.index_select(params['pcr'], 0, rows),
            params['uh'], params['uv'], params['m'])

    if op == 'field_interleave':
        # a 2:3 pulldown frame: even absolute rows in [start_y, end_y]
        # and columns in [x0, x1] (frame a's window) come from child b,
        # the rest from child a (render.py:1033-1051). Rows are absolute,
        # so a window that starts at a negative y needs the floored
        # remainder (torch.remainder; torch.fmod would keep the sign).
        a = _eval(child_sigs[0], params_iter, device)
        b = _eval(child_sigs[1], params_iter, device)
        (min_y, min_x) = static
        H, W = a.shape[2], a.shape[3]
        rows = torch.arange(H, dtype=torch.int32,
                            device=device).view(1, 1, H, 1) + min_y
        cols = torch.arange(W, dtype=torch.int32,
                            device=device).view(1, 1, 1, W) + min_x
        start = params['start_y'][:, None, None, None]
        end = params['end_y'][:, None, None, None]
        x0 = params['x0'][:, None, None, None]
        x1 = params['x1'][:, None, None, None]
        mask = ((rows >= start) & (rows <= end)
                & (torch.remainder(rows, 2) == 0)
                & (cols >= x0) & (cols <= x1))
        return torch.where(mask, b, a)

    if op == 'transfer':
        # a named curve on all four channels, by the f16 bits of the child
        # rounded to the f16 grid (render.py:1142-1147)
        child = _eval(child_sigs[0], params_iter, device)
        return color_ops.device_transfer(static[0],
                                         color_ops.quantize_f16(child))

    if op == 'u8_linearize':
        # decoded u8 RGBA, staged in the decoder's interleaved (B, H, W, 4)
        # layout: made planar on the device, /255 in f32, rounded to the
        # f16 grid to nearest (not the curves' truncating grid), then the
        # rec709 -> linear scene curve on all four channels
        # (render.py:1157-1167)
        data = params['data'].permute(0, 3, 1, 2).contiguous()
        return color_ops.device_transfer(
            'rec709_to_linear_scene',
            color_ops.quantize_f16(data.float() / 255.0))

    if op == 'matrix':
        # a 3x3 color matrix over rgb at full f32 (TF32 stays off); alpha
        # passes through (render.py:1149-1155)
        child = _eval(child_sigs[0], params_iter, device)
        rgb = torch.einsum('ij,bjhw->bihw', params['m'], child[:, :3])
        return torch.cat([rgb, child[:, 3:]], dim=1)

    if op == 'place':
        # static re-window: the child's [sy0..sy1, sx0..sx1] copied to
        # (dy0, dx0) of a zero (dst_h, dst_w) frame
        child = _eval(child_sigs[0], params_iter, device)
        (dst_h, dst_w, sy0, sy1, sx0, sx1, dy0, dx0) = static
        out = torch.zeros((child.shape[0], 4, dst_h, dst_w),
                          dtype=torch.float32, device=device)
        h, w = sy1 - sy0 + 1, sx1 - sx0 + 1
        if h > 0 and w > 0:
            out[:, :, dy0:dy0 + h, dx0:dx0 + w] = \
                child[:, :, sy0:sy0 + h, sx0:sx0 + w]
        return out

    if op == 'scale':
        # static taps shared by the segment: (T, S) or per frame (B, T, S)
        child = _eval(child_sigs[0], params_iter, device)
        Wy, Wx = params['wy'], params['wx']
        if Wy.dim() == 2:
            tmp = torch.einsum('yh,bchw->bcyw', Wy, child)
            return torch.einsum('xw,bcyw->bcyx', Wx, tmp)
        tmp = torch.einsum('byh,bchw->bcyw', Wy, child)
        return torch.einsum('bxw,bcyw->bcyx', Wx, tmp)

    if op == 'scale_taps_dyn':
        # animated resample: per-frame taps from scalar params, densified
        # to (B, T, S) matrices and contracted (render.py:1053-1094).
        # The quality <= 5 'lq' taps are bilinear; their products stay at
        # full f32 like the others (the JAX package's precision=None
        # would allow less, see PERF.md section 7).
        child = _eval(child_sigs[0], params_iter, device)
        (Ky, Kx, Ty, Tx, lq) = static
        Sy, Sx = child.shape[2], child.shape[3]
        iy, wy = _dyn_axis_taps(params['fy'], params['tpy'], params['spy'],
                                params['yl'], params['yh'], params['tly'],
                                Ty, Ky, lq, Sy)
        ix, wx = _dyn_axis_taps(params['fx'], params['tpx'], params['spx'],
                                params['xl'], params['xh'], params['tlx'],
                                Tx, Kx, lq, Sx)
        mid = torch.einsum('bts,bcsw->bctw', _densify(iy, wy, Sy), child)
        return torch.einsum('bxw,bctw->bctx', _densify(ix, wx, Sx), mid)

    if op in _LATER:
        raise _not_ported('op %r' % (op,), _LATER[op])
    raise ValueError('unknown op: %r' % (op,))


def _over_stack(static, child_sigs, params_iter, device, out_dtype,
                split=False):
    """Premultiplied-alpha fold of the children (render.py:869-1015).
    Solid runs fold through the ``solid_fold`` kernel (the last one
    finalizes straight to *out_dtype*); each placed rank-1 region
    composites through ``region_over_sep`` in place (its offsets read on
    the device), any other placed region layer through ``region_over``
    in place; any other child is a layer blended with torch ops.

    With *split* (a render program's root) the op that writes the frames
    is left out and returned instead: ``(outs, finish)``, where *outs*
    are the accumulators a captured graph leaves in its pool and
    ``finish(outs)`` writes fresh frames from them (the finalizing
    ``solid_fold``, or the f16 store of the un-premultiplied result).

    The (P, A) accumulators are f32, or at quality <= 9 (the ``acc16``
    tag) bf16 at every pass boundary: the kernels store them as bf16,
    the region layer of ``region_over`` is rounded to bf16 too, while
    all blend math stays f32. A torch-blended layer works on upcast
    accumulators (render.py:1008-1011), and the un-premultiply at the
    end runs in f32."""
    H, W = static[0], static[1]
    acc16 = len(static) > 2 and static[2] == 'acc16'
    acc_dt = torch.bfloat16 if acc16 else torch.float32

    def to_acc(x):
        # the kernels take contiguous accumulators of the tier's dtype;
        # a first torch-blended layer leaves A as a strided f32 view
        return x.to(acc_dt).contiguous()

    P = A = None
    c_op = None
    try:
        for i, cs in enumerate(child_sigs):
            c_op = cs[0]
            if c_op == 'solid_stack':
                c_params = next(params_iter)
                if P is not None:
                    P, A = P.contiguous(), A.contiguous()
                if i == len(child_sigs) - 1:
                    finish = functools.partial(_finalize, c_params, H, W,
                                               out_dtype)
                    if split and P is not None:
                        return (P, A), finish
                    out = finish((P, A))
                    return ((out,), _to_f16) if split else out
                P, A = cuda_ops.solid_fold(
                    to_acc(P) if P is not None else None,
                    to_acc(A) if A is not None else None,
                    c_params['color'], c_params['box'], c_params['gain'],
                    c_params['offset'], H, W, acc_dtype=acc_dt)
                continue
            if c_op == 'placed':
                pl_params = next(params_iter)
                inner = cs[3][0]
                if inner[0] in ('scale_solid', 'scale_solid_dyn'):
                    color, ry, rx = _scale_solid_factors(
                        inner[0], inner[1], next(params_iter))
                    layer = None
                    B = color.shape[0]
                else:
                    layer = _eval(inner, params_iter, device).contiguous()
                    B = layer.shape[0]
                if P is None:
                    P = torch.zeros((B, 3, H, W), dtype=acc_dt,
                                    device=device)
                    A = torch.zeros((B, 1, H, W), dtype=acc_dt,
                                    device=device)
                if layer is None:
                    P, A = cuda_ops.region_over_sep(
                        to_acc(P), to_acc(A), color, ry, rx,
                        pl_params['dy0'], pl_params['dx0'])
                else:
                    P, A = cuda_ops.region_over(
                        to_acc(P), to_acc(A), to_acc(layer),
                        pl_params['dy0'], pl_params['dx0'])
                continue
            layer = _eval(cs, params_iter, device)
            la = layer[:, 3:4]
            if P is None:
                P = layer[:, :3] * la
                A = la
            else:
                P = layer[:, :3] * la + P.float() * (1.0 - la)
                A = la + A.float() * (1.0 - la)
    except Exception as err:
        _tag_op(err, c_op)     # the child whose fold or composite raised
        raise
    P, A = P.float(), A.float()
    nz = A != 0.0
    rgb = torch.where(nz, P / torch.where(nz, A, 1.0), 0.0)
    out = torch.cat([rgb, A], dim=1)
    return ((out,), _to_f16) if split else out


def _finalize(c_params, H, W, out_dtype, outs):
    """The root's last solid run folded over the accumulators *outs* and
    finalized to fresh *out_dtype* frames (a program's finish)."""
    P, A = outs
    return cuda_ops.solid_fold(P, A, c_params['color'], c_params['box'],
                               c_params['gain'], c_params['offset'], H, W,
                               finalize=True, out_dtype=out_dtype)


def _to_f16(outs):
    """The frames of *outs* (one tensor) stored as fresh f16: the
    conversion of ``run``'s ``.to(torch.float16)``, into a tensor of its
    own even where the source is f16 already (a program's finish)."""
    x, = outs
    return torch.empty(x.shape, dtype=torch.float16,
                       device=x.device).copy_(x)


def run(sig, params, device, post=None):
    """Evaluate *sig* over tensor *params* (``params_to_torch``) and return
    the (B, 4, H, W) f16 frames (render.py:1476-1480), or their export
    conversion ``post`` (``color.POSTS``, render.py:1481-1487)."""
    out = _eval(sig, iter(params), device, torch.float16).to(torch.float16)
    return out if post is None else color_ops.POSTS[post](out)


def display_run(sig, params, device, mats, order, intent, transport):
    """The display program of ``render_display`` (render.py:2193-2213):
    the frame rendered, resampled to the viewport by *mats* (Dy, Dx) when
    given (two f32 contractions of the f32 composite, then the f16
    quantize), and converted for *transport*: 'u8' interleaves the
    channels of *order* (the gamma45 ramp for ``intent=None``, else the
    sRGB + intent conversion), 'rgb24' the same without alpha, 'yuv420'
    the lossy 4:2:0 pack. Returns the (B, ...) u8 tensor on *device*."""
    if mats is None:
        out = run(sig, params, device)
    else:
        dy, dx = mats
        out = _eval(sig, iter(params), device)
        out = torch.einsum('yh,bchw->bcyw', dy, out)
        out = torch.einsum('xw,bcyw->bcyx', dx, out).to(torch.float16)
    if transport == 'yuv420':
        return color_ops.yuv420_pack(out, intent)
    if transport == 'rgb24':
        # only the color channels cross to the host; alpha pads there
        order = tuple(c for c in order if c != 3)
    if intent is None:
        return color_ops.u8_interleaved(out, order)
    return color_ops.display_u8(out, intent, order)


# --- render programs (canvas_tpu/render.py:1302-1487) ---------------------

#: The render programs, by key, least recently used first: the
#: counterpart of the JAX package's ``_program_cache`` of compiled
#: programs. A key is ``(signature, device)``, ``((signature, 'post',
#: post), device)`` or, for ``render_display``, ``((one-frame signature,
#: 'display', order, intent, display_size, transport), device)``. The JAX
#: keys also carry ``_trace_env_key``'s TPU A/B gates, which the port
#: does not have (ROADMAP.md item 9).
_program_cache = OrderedDict()
_program_lock = threading.Lock()

#: Most programs kept at once, over every device. A captured program
#: keeps its graph's memory pool for as long as it lives (an XLA program
#: frees its buffers between calls), so the cache is bounded, by count
#: here and by the memory guard's budget (``_make_room``).
_PROGRAMS_KEPT = 32

#: ``(full segment signature, device)`` -> how many live programs render
#: a form of that segment (a batch cut, a post, a display pull): what
#: ``explain`` reports as "program CAPTURED" (render.py:1330-1336).
_compiled_families = {}

#: Program calls, captures, replays, captures replayed at least once,
#: evictions and orphans (captures by a program that had left the cache
#: meanwhile, which no later call can replay) since import
#: (``program_stats``).
_program_totals = {'calls': 0, 'captures': 0, 'replays': 0,
                   'replayed_captures': 0, 'evictions': 0, 'orphans': 0}

#: The side stream of each card that programs are captured on (a
#: capture needs a stream of its own), and the lock one capture at a
#: time holds (the pull queue's workers may capture two programs at
#: once). Work that another thread enqueues on a stream while it is
#: captured joins the capture, and a wait for that stream invalidates
#: it; torch hands out its pooled streams round robin, so the side
#: stream comes from the pool of the highest priority, which nothing
#: else of the port draws from (``staging._copy_stream`` keeps one copy
#: stream a device for the same reason).
_side_streams = {}
_capture_lock = threading.Lock()


def _program_device(device):
    """*device* with an index where it is a card (``torch.device('cuda')``
    is the current card), so one card has one key."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _side_stream(device):
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(
            device, priority=torch.cuda.Stream.priority_range()[1])
    return stream


class _Program:
    """One render program: the body of a signature captured as ONE CUDA
    graph on its card and replayed for every later batch, segment and
    cold pass with that signature, as the JAX package replays one
    ``jax.jit`` program (``canvas_tpu.render._get_program``). A replay
    launches the very kernels the eager run launched, in the same order,
    so its frames are the eager ``run``'s bit for bit.

    - **Static inputs.** The program owns one param buffer in the leaf
      layout of ``params_to_torch`` (fixed by the signature) and one
      slot per tensor that passes through (a staged stack, a display
      pull's device params). A call copies a host param list into the
      buffer in one packed host-to-device copy, or a ``_DeviceParams``
      (a cached plan's params) in one device copy; a slot is copied only
      when its source tensor is not the one it last copied (held weakly:
      a freed source can never match).
    - **Capture.** The first call runs the body eagerly on the static
      inputs and returns its frames; a signature rendered once (a tail
      batch, a thumbnail) captures nothing. The second call, after the
      memory guard found room for the batch and the new pool beside the
      live programs (what it cannot fit raises), runs the body eagerly
      once more on the card's side stream and returns those frames: the
      warm-up, on the capture's own thread and stream, so the cuBLAS
      handle and workspaces, the level tables and the kernel library
      exist; then it captures on that stream into the graph's private
      pool, in ``thread_local`` mode, so the prepare thread's copies and
      waits go on (the ctypes kernels launch on torch's current stream,
      the capture stream then). Every later call replays. Each call
      launches, or replays, one batch's kernels. A capture that fails
      raises, naming the op (``canvas_op``); nothing falls back to an
      eager run on a card.
    - **Outputs.** The graph ends before the op that writes the returned
      tensor: its ``finish`` (the root's finalizing ``solid_fold`` or its
      f16 store, then the post; a display pull's copy to the host) runs
      eagerly after each replay into fresh memory, reading the pool in
      stream order before the next replay can write it. The caller owns
      what it gets, as a JAX program's caller does.
    - **Launch counts.** A replay runs no wrapper, so the program adds
      the launches it recorded at capture (``cuda_ops.recording``).
    - **Streams and threads.** One call at a time (a lock); a call on
      another stream than the last waits for the last one first.
    - **Eviction.** An evicted program keeps nothing and never runs
      again: a caller that still holds it (``iter_batches`` takes a
      segment's program once for all its batches) reaches the cache's
      entry of its key through ``_program`` at every later call, made
      anew where there is none. So every capture lives in the cache,
      where the memory guard, ``explain`` and the counts see it.

    On the CPU there is no graph: the same binding, guard, body and
    finish run eagerly at every call, the second one counting as the
    capture."""

    def __init__(self, key, device, body, family=None):
        self.key = key
        self.device = device
        self.family = family
        self._body = body
        self._lock = threading.Lock()
        #: the batch's memory estimate with the pool, which the capture
        #: must find room for (the latest caller's, ``_program``)
        self.reserve = 0
        self.calls = 0
        self.replays = 0
        self.capture_ms = None
        #: where a card's capture took its time (ms): the eager warm-up
        #: batch's enqueue, making room (``empty_cache``, only where the
        #: card lacks it), recording the body, instantiating the graph
        self.capture_split = None
        self.pool_bytes = 0
        self.slot_copies = 0
        self.slot_bytes = 0
        self.out_shape = None
        #: ``program_stats()['captures']`` right after this capture
        self.capture_index = None
        #: what the memory guard counted when it let this program
        #: capture: the batch's estimate with the new pool, and the bytes
        #: of the programs live then
        self.guard_bytes = 0
        #: set when the program leaves the cache; its holders' calls go
        #: through ``_program`` from then on
        self.evicted = False
        #: whether ``_compiled_families`` counts this program
        self._in_family = False
        self._reset()

    def _reset(self):
        self.captured = False
        self.params = None
        self._buffer = None
        self._leaf_key = None
        self._slots = None
        self._graph = None
        self._outs = None
        self._finish = None
        self._launches = None
        self._stream = None

    @property
    def held_bytes(self):
        """Device bytes this program keeps: its pool, param buffer and
        slots."""
        if self.params is None:
            return 0
        return (self.pool_bytes + self._buffer.numel()
                + sum(s[2].numel() * s[2].element_size()
                      for s in self._slots))

    def stats(self):
        return {'key': _describe_key(self.key), 'device': str(self.device),
                'frames': self.out_shape, 'captured': self.captured,
                'capture_index': self.capture_index,
                'guard_bytes': self.guard_bytes,
                'calls': self.calls, 'replays': self.replays,
                'capture_ms': self.capture_ms,
                'capture_split': self.capture_split,
                'pool_bytes': self.pool_bytes,
                'held_bytes': self.held_bytes,
                'param_bytes': (0 if self._buffer is None
                                else self._buffer.numel()),
                'slot_copies': self.slot_copies,
                'slot_bytes': self.slot_bytes}

    def __call__(self, plist):
        """Run the program on *plist* (host params as planned, or a
        ``_DeviceParams``) and return what its finish writes. An evicted
        program runs the cache's entry of its key instead."""
        with self._lock:
            if not self.evicted:
                return self._run(plist)
        return _program(self.key, lambda: self._body, self.reserve,
                        self.family)(plist)

    def _run(self, plist):
        """A call, under the program's lock."""
        if self.device.type == 'cuda':
            cur = torch.cuda.current_stream(self.device)
            if self._stream is not None and self._stream != cur:
                cur.wait_stream(self._stream)
            self._stream = cur
        with profiling.Timer('render.bind'):
            self._bind(plist)
        replayed = self.captured
        first_replay = replayed and not self.replays
        capture = not replayed and self.calls
        with profiling.Timer('render.replay'):
            if capture:
                # its eager warm-up batch's finish included
                out = self._capture()
            else:
                # a replay, or the first call: the body eagerly on the
                # static inputs, its launches real
                outs, finish = (self._replay() if replayed
                                else self._body(self.params))
        if not capture:
            out = finish(outs)
        self.replays += replayed
        self.calls += 1
        if self.out_shape is None:
            self.out_shape = tuple(out.shape)
        with _program_lock:
            _program_totals['calls'] += 1
            _program_totals['replays'] += replayed
            _program_totals['replayed_captures'] += first_replay
        return out

    # binding

    def _layout(self, plist):
        """The static inputs, laid out from the first param list: the
        leaves of ``params_to_torch``'s layout in one buffer, a slot for
        every tensor."""
        if isinstance(plist, _DeviceParams):
            self._leaf_key = plist.leaf_key
        else:
            self._leaf_key = _leaf_key(_leaf_layout(plist)[0])
        size = 0
        at = {}
        for i, k, dt, shape, off in self._leaf_key:
            at[(i, k)] = (dt, shape, off)
            size = off + -(-_nbytes(dt, shape) // 16) * 16
        self._buffer = torch.empty(size, dtype=torch.uint8,
                                   device=self.device)
        self.params, self._slots = [], []
        for i, p in enumerate(plist):
            q = {}
            for k, v in p.items():
                if (i, k) in at:
                    q[k] = _leaf_view(self._buffer, *at[(i, k)])
                else:
                    q[k] = torch.empty(v.shape, dtype=v.dtype,
                                       device=self.device)
                    self._slots.append([i, k, q[k], None])
            self.params.append(q)

    def _bind(self, plist):
        """Copy *plist* into the static inputs, on the current stream."""
        if self.params is None:
            self._layout(plist)
        if len(plist) != len(self.params):
            raise ValueError('%d param dicts for a program of %d nodes'
                             % (len(plist), len(self.params)))
        cuda = self.device.type == 'cuda'
        if (isinstance(plist, _DeviceParams)
                and plist.leaf_key == self._leaf_key):
            self._buffer.copy_(plist.buffer, non_blocking=True)
        else:
            leaves, tensors = [], []
            for i, k, dt, shape, off in self._leaf_key:
                v = plist[i][k]
                if isinstance(v, torch.Tensor):
                    tensors.append((self.params[i][k], v))
                    continue
                a = _canonical(v)
                if a.dtype.str != dt or a.shape != shape:
                    raise ValueError(
                        'param %r of node %d is %s %s; the program takes %s '
                        '%s' % (k, i, a.dtype, a.shape, dt, shape))
                leaves.append((i, k, np.ascontiguousarray(a).reshape(-1),
                               shape, off))
            if leaves:
                size = self._buffer.numel()
                self._buffer.copy_(_pack(leaves, size, cuda),
                                   non_blocking=cuda)
                if cuda:
                    backend.count_h2d(size, 1)
            for dst, v in tensors:
                dst.copy_(v, non_blocking=True)
        for slot in self._slots:
            i, k, dst, last = slot
            v = plist[i][k]
            if isinstance(v, torch.Tensor):
                if last is not None and last() is v:
                    continue
                dst.copy_(v, non_blocking=True)
                slot[3] = weakref.ref(v)
            else:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(
                    _canonical(v))).reshape(dst.shape))
                slot[3] = None
            self.slot_copies += 1
            self.slot_bytes += dst.numel() * dst.element_size()

    # capture and replay

    def _capture(self):
        """The second call: this batch's frames eagerly (the warm-up, on
        the stream the capture then uses), then the capture. Returns the
        frames."""
        # the memory guard at the capture: the batch with the new pool,
        # beside the programs live now (the tail batch's signature after
        # the main one's, say); what no eviction can fit raises
        held = _make_room(self.device, self.reserve, keep=self)
        budget = _hbm_budget_bytes(self.device)
        if budget and self.reserve + held > budget:
            raise ValueError(
                'capturing the render program %s on %s needs ~%.1f GiB '
                'beside ~%.1f GiB of live render programs, against a ~%.1f '
                'GiB HBM budget (CANVAS_HBM_MB overrides it, 0 disables the '
                'check)' % (_describe_key(self.key), self.device,
                            self.reserve / (1 << 30), held / (1 << 30),
                            budget / (1 << 30)))
        self.guard_bytes = self.reserve + held
        t0 = time.perf_counter()
        if self.device.type == 'cuda':
            backend.ensure_initialized()   # TF32 stays off in the capture
            with _capture_lock:
                out = self._capture_on_side_stream()
        else:
            outs, finish = self._body(self.params)
            out = finish(outs)
        self.captured = True
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        with _program_lock:
            _program_totals['captures'] += 1
            self.capture_index = _program_totals['captures']
            if self.evicted or _program_cache.get(self.key) is not self:
                # evicted during this call (its release waits for it), or
                # never in the cache
                _program_totals['orphans'] += 1
            elif self.family is not None:
                fk = (self.family, self.device)
                _compiled_families[fk] = _compiled_families.get(fk, 0) + 1
                self._in_family = True
        return out

    def _capture_on_side_stream(self):
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            # this batch's frames, eagerly on the capture's thread and
            # stream: what the body creates there lazily (a cuBLAS
            # handle, its workspaces) exists before the capture
            outs, finish = self._body(self.params)
            out = finish(outs)
            del outs
            t1 = time.perf_counter()
            # The pool takes device memory of its own (no cached block of
            # another pool). Only where the card lacks the room the
            # memory guard counted for the batch and its pool does the
            # allocator hand its cached blocks back first (the pools of
            # evicted programs among them): a synchronize of the whole
            # card, which torch.cuda.graph makes before every capture.
            # Nothing else waits: the warm-up stays queued on the side
            # stream, ahead of the capture.
            if torch.cuda.mem_get_info(self.device)[0] < self.reserve:
                torch.cuda.empty_cache()
            t2 = time.perf_counter()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # No collection runs during the capture: a tensor freed then
            # would record events from the capturing thread.
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(capture_error_mode='thread_local')
                try:
                    with cuda_ops.recording() as launches:
                        outs, finish = self._body(self.params)
                except Exception as err:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass               # the capture is invalid already
                    raise self._failed(err) from err
                t3 = time.perf_counter()
                try:
                    graph.capture_end()
                except RuntimeError as err:
                    raise self._failed(err) from err
            finally:
                if collecting:
                    gc.enable()
            t4 = time.perf_counter()
            growth = torch.cuda.memory_reserved(self.device) - reserved
        cur.wait_stream(side)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            out.record_stream(cur)         # made on the side stream
        self._graph, self._outs, self._finish = graph, outs, finish
        self._launches = launches
        # the pool's segments (allocated anew: a pool takes no cached
        # block of another)
        self.pool_bytes = max(0, int(growth))
        self.capture_split = {
            'warm_ms': (t1 - t0) * 1e3, 'room_ms': (t2 - t1) * 1e3,
            'record_ms': (t3 - t2) * 1e3, 'instantiate_ms': (t4 - t3) * 1e3}
        return out

    def _failed(self, err):
        return RuntimeError(
            'capturing the render program %s on %s failed in op %r: %s: %s'
            % (_describe_key(self.key), self.device,
               getattr(err, 'canvas_op', None), type(err).__name__, err))

    def _replay(self):
        if self._graph is not None:
            self._graph.replay()
            cuda_ops.add_launches(self._launches)
            return self._outs, self._finish
        with cuda_ops.recording() as launches:
            outs, finish = self._body(self.params)
        if self._launches is None:
            self._launches = launches
        cuda_ops.add_launches(self._launches)
        return outs, finish

    def _release(self, blocking=True):
        """Drop the graph, its pool and the static inputs (an eviction),
        once the card is done with them; later calls go to the cache's
        entry of the key. Without *blocking*, a program in use on another
        thread is left as it is: returns whether it was released."""
        if not self._lock.acquire(blocking):
            return False
        try:
            if self._stream is not None:
                self._stream.synchronize()
            self.evicted = True
            if self._in_family:
                fk = (self.family, self.device)
                with _program_lock:
                    left = _compiled_families.get(fk, 0) - 1
                    if left > 0:
                        _compiled_families[fk] = left
                    else:
                        _compiled_families.pop(fk, None)
                self._in_family = False
            self.pool_bytes = 0
            self._reset()
        finally:
            self._lock.release()
        return True


def _nbytes(dtype_str, shape):
    return np.dtype(dtype_str).itemsize * int(np.prod(shape, dtype=np.int64))


def _describe_key(key):
    """A short name of a program key: the root op, the post or the
    display transport."""
    what, _device = key
    if what[1] == 'post':
        return '%s post=%s' % (what[0][0], what[2])
    if what[1] == 'display':
        return '%s display %s %s' % (what[0][0], what[5], what[4] or 'full')
    return what[0]


def _make_run(signature, post, device):
    """The program body of *signature* (render.py:1463-1487): the
    evaluation up to the op that writes the frames, with a finish that
    writes them as fresh f16 and converts them for export by *post*
    (``color.POSTS``). ONE definition for the sharded and unsharded
    programs."""
    post_fn = None if post is None else color_ops.POSTS[post]

    def body(params):
        outs, finish = _split_eval(signature, iter(params), device)
        if post_fn is None:
            return outs, finish

        def finish_post(o):
            frames = finish(o)
            with profiling.Timer('render.post'), \
                    profiling.device_span('render.post.device', device):
                return post_fn(frames)

        return outs, finish_post

    return body


def _split_eval(sig, params_iter, device):
    """``run``'s evaluation as ``(outs, finish)``: ``finish(outs)`` is the
    op that writes the returned frames, left out of a captured graph (the
    root ``over_stack``'s last solid fold or its f16 store, else the f16
    store of the root)."""
    op, static, _, child_sigs = sig
    if op != 'over_stack':
        return (_eval(sig, params_iter, device, torch.float16),), _to_f16
    next(params_iter)
    try:
        return _over_stack(static, child_sigs, params_iter, device,
                           torch.float16, split=True)
    except Exception as err:
        _tag_op(err, op)
        raise


def _fetch(outs):
    """A display program's finish: its u8 frames copied to the host."""
    return backend.to_host(outs[0])


def _held_bytes(device):
    """Device bytes the live programs on *device* keep."""
    with _program_lock:
        progs = [p for p in _program_cache.values() if p.device == device]
    return sum(p.held_bytes for p in progs)


def _evict(victims):
    for prog in victims:
        prog._release()
    with _program_lock:
        _program_totals['evictions'] += len(victims)


#: The share of the memory guard's budget above which a render is
#: marginal: it warns there, and live programs are evicted to stay below
#: it, leaving room for what the estimate does not model (outputs a
#: caller keeps past its depth, the allocator's cached blocks).
_MARGINAL = 0.8


def _make_room(device, need, keep=None):
    """Evict the least recently used programs on *device* while their
    bytes and *need* (a batch's estimate) would pass the marginal share
    of the memory guard's budget (``_MARGINAL`` of ``_hbm_budget_bytes``),
    never *keep* (the program about to capture). Returns the bytes the
    programs left on *device* keep."""
    device = _program_device(device)
    budget = _hbm_budget_bytes(device)
    held = _held_bytes(device)
    busy = {id(keep)}
    while budget and need + held > _MARGINAL * budget:
        with _program_lock:
            victim = next((p for p in _program_cache.values()
                           if p.device == device and id(p) not in busy
                           and p.held_bytes), None)
        if victim is None:
            break
        # a program another thread runs is skipped, not waited for: that
        # thread may be making room itself
        if not victim._release(blocking=False):
            busy.add(id(victim))
            continue
        with _program_lock:
            if _program_cache.get(victim.key) is victim:
                del _program_cache[victim.key]
            _program_totals['evictions'] += 1
        held = _held_bytes(device)
    return held


def _program(key, make_body, reserve=0, family=None):
    """The program of *key*, made when there is none (its first call runs
    eagerly, its second captures). *reserve* is the batch's memory
    estimate with a new pool (``_check_hbm_footprint``), which the
    capture must find room for beside the programs live then. The least
    recently used programs past ``_PROGRAMS_KEPT`` are evicted; an entry
    the memory guard released (``_make_room``, before it drops the
    entry) counts as none."""
    victims = []
    with _program_lock:
        prog = _program_cache.get(key)
        if prog is None or prog.evicted:
            prog = _program_cache[key] = _Program(key, key[1], make_body(),
                                                  family)
        _program_cache.move_to_end(key)
        if reserve:
            prog.reserve = reserve
        while len(_program_cache) > _PROGRAMS_KEPT:
            victim = _program_cache.popitem(last=False)[1]
            # out of the cache from here on: its holders' next calls come
            # back here, and a capture it makes meanwhile is an orphan
            victim.evicted = True
            victims.append(victim)
    _evict(victims)
    return prog


def _get_program(signature, device, post=None, reserve=0, family=None):
    """The render program of *signature* on *device* (render.py:1445-1475):
    ``post`` None gives (B, 4, H, W) f16 frames, else their export
    conversion (``color.POSTS``) in the program's finish. *reserve* is
    the batch's memory estimate, room made for it before a capture;
    *family* the unsliced segment signature ``explain`` reports."""
    device = _program_device(device)
    key = ((signature if post is None else (signature, 'post', post)),
           device)
    return _program(key, lambda: _make_run(signature, post, device),
                    reserve, family)


def _get_sharded_program(signature, devices, post=None, reserve=0,
                         family=None):
    """The program of each frame shard of a batch (render.py:1382-1405):
    one per (shard signature, device), so a mesh that names a device
    twice replays that device's program once per shard; stream order
    keeps the shards apart (each shard's finish reads the pool before the
    next replay writes it). *reserve* maps a device to its share of the
    batch's estimate."""
    return [_get_program(signature, d, post,
                         (reserve or {}).get(d, 0), family)
            for d in devices]


def _get_display_program(sig1, device, order, intent, display_size,
                         transport, reserve=0, family=None):
    """The display program of ``render_display`` under the JAX key
    (render.py:2183-2217): ``display_run`` whole, viewport resample
    included (its matrices a trailing param dict ``{'dy', 'dx'}``), and
    the u8 result copied to the host as its finish."""
    device = _program_device(device)
    key = ((sig1, 'display', order, intent, display_size, transport),
           device)

    def make():
        def body(params):
            mats = None
            if display_size is not None:
                mats = (params[-1]['dy'], params[-1]['dx'])
                params = params[:-1]
            try:
                out = display_run(sig1, params, device, mats, order, intent,
                                  transport)
            except Exception as err:
                _tag_op(err, 'display %s' % transport)
                raise
            return (out,), _fetch
        return body

    return _program(key, make, reserve, family)


def program_stats():
    """The render programs: totals since import (``calls``, ``captures``,
    ``replays``, ``replayed_captures``: the captures a later call replayed
    at least once, ``evictions``, ``orphans``: captures by a program out
    of the cache, which no later call replays), the ``live`` count, and
    per live program (least recently used first) its key, device, output
    shape, calls, replays, capture ms and its split (``capture_split``),
    pool bytes, bytes held (pool, param buffer and slots), param buffer
    bytes, the slot copies made with their bytes, ``capture_index`` (the captures total right after its capture) and
    ``guard_bytes`` (what the memory guard counted at its capture)."""
    with _program_lock:
        progs = list(_program_cache.values())
        totals = dict(_program_totals)
    return dict(totals, live=len(progs),
                programs=[p.stats() for p in progs])


@functools.lru_cache(maxsize=16)
def _display_matrices_host(window_h, window_w, dh, dw):
    mats = []
    for d, n in ((dh, window_h), (dw, window_w)):
        m, _touched = scale_ops.axis_matrix(d / n, 0, d - 1, 0, n - 1,
                                            0.0, 0.0)
        m.setflags(write=False)       # shared by every caller
        mats.append(m)
    return tuple(mats)


def display_matrices_host(window_h, window_w, display_size):
    """Host (dh, H), (dw, W) f32 triangle-FIR viewport-resample matrices
    for ``display_size=(dw, dh)`` (the filter.c:24-77 family, anchored at
    the window origin like VideoScaler's point convention;
    render.py:2365-2384). ``render_display`` and the playback engine
    both resample through these. The arrays are cached and read-only."""
    return _display_matrices_host(int(window_h), int(window_w),
                                  int(display_size[1]),
                                  int(display_size[0]))


def _hbm_budget_bytes(device):
    """Device-memory budget for the pre-dispatch footprint check
    (render.py:1513-1547): ``CANVAS_HBM_MB`` when set (0 or less
    switches every check off and gives 0), else the card's total memory
    (``torch.cuda.mem_get_info``: the total, not the free share, since
    the port's own caches live in the rest), else None: on the CPU there
    is nothing to guard."""
    env = os.environ.get('CANVAS_HBM_MB')
    if env is not None:
        try:
            mb = float(env)
        except ValueError:
            _log.warning('CANVAS_HBM_MB=%r is not a number (want MB, e.g. '
                         '81920); falling back to device detection', env)
        else:
            return int(mb * (1 << 20)) if mb > 0 else 0
    if device.type != 'cuda':
        return None
    return int(torch.cuda.mem_get_info(device)[1])


#: The working set of each export post of ``color_ops.POSTS`` at its
#: peak, in bytes per pixel of the batch, one term per tensor live there.
#: All three start with ``_gamma45_floor``'s level gather
#: (``_display_levels``), and its gather is the peak: the f16 bits widen
#: to int32 and are masked (a second int32 tensor, the first freed when
#: the mask is done), the gather converts its int32 indices to int64,
#: and writes f32 levels, while the caller still holds the f16 frame.
#: The ``floor`` of the levels (16 B/px, beside the 16 of the levels)
#: comes after the bits and indices are freed, and what follows it (the
#: u8 copies of the interleave, yuv420's f32 planes of 4 B/px each) is
#: smaller again, so none of it adds to that peak.
POST_WORKING_BPP = {
    post: (('f16 frame', 8), ('int32 bits', 16), ('int64 indices', 32),
           ('f32 levels', 16))
    for post in ('rgba_u8', 'bgra_u8', 'yuv420')}


def _hbm_estimate_bytes(batch, window, post, max_inflight, working_bpp=16,
                        device=None):
    """The memory guard's model of a batched render, in bytes, and the
    output depth it counted: ``depth`` retained output buffers
    (``max_inflight``, 3 when unbounded or non-positive, as in
    ``iter_batches``; 8 / 4 / 1.5 bytes per pixel by *post*), ONE
    working stack of ``working_bpp`` bytes per pixel (the f32 (P, A)
    accumulators), and with a *post* that post's working set,
    ``POST_WORKING_BPP``: per pixel, the f16 frame it reads (8), the
    int32 bits of its level gather (16), the gather's int64 indices
    (32) and the f32 levels (16), 72 bytes for each of ``rgba_u8``,
    ``bgra_u8`` and ``yuv420``. The accumulators are freed by the
    finalize before the post runs, so the sum is an upper bound. With
    *device*, the bytes the live render programs on it keep (their graph
    pools, measured at capture, param buffers and slots) are added; the
    pool of a program still to capture is the capture's to find room for
    (``_check_hbm_footprint``, ``_Program._capture``)."""
    px = window.width * window.height
    out_bpp = {None: 8, 'rgba_u8': 4, 'bgra_u8': 4,
               'yuv420': 1.5}.get(post, 8)
    post_bpp = sum(b for _name, b in POST_WORKING_BPP.get(post, ()))
    depth = max_inflight if (max_inflight and max_inflight > 0) else 3
    est = int((depth * out_bpp + working_bpp + post_bpp) * batch * px)
    if device is not None:
        est += _held_bytes(_program_device(device))
    return est, depth


def _check_hbm_footprint(batch, window, post, max_inflight, device,
                         working_bpp=16, shares=None):
    """Estimate the device memory of a batched render and refuse a
    clearly-over-budget one BEFORE any launch (render.py:1550-1598): an
    out-of-memory error would otherwise end a stream part-way, after the
    host planned and staged it and the caller consumed earlier batches,
    and its message names an allocation size, not the batch that asked
    too much.

    Model (``_hbm_estimate_bytes``): ``depth`` retained output buffers
    (``max_inflight``, 3 when unbounded; 8 / 4 / 1.5 bytes per pixel by
    *post*) plus ONE working stack of ``working_bpp`` bytes per pixel
    for the executing batch, the f32 accumulators (0 for the cumulative
    check of a collector that keeps every batch's output; its per-batch
    working set is checked apart), plus the post's working set
    (``POST_WORKING_BPP``). PyTorch's allocator hands a dropped output's
    memory to the next batch in stream order, so the depth stands for
    the batches a caller holds at once (an exporter converts one while
    the next renders), not for queued work. Raises above the budget
    (``_hbm_budget_bytes``), logs a warning above 80% of it.

    Over a mesh, *shares* maps each distinct device to the number of the
    batch's frame shards it renders (``_device_shares``), and each device
    is held to its own budget with its share of the estimate. The JAX
    guard divides by the shard count (render.py:1576-1578), which is
    right only when every shard has a device of its own: a device named
    twice holds two shards' worth. None means *device* renders it all.

    The live render programs on each device count too (their pools,
    param buffers and slots): the least recently used are evicted
    (``_make_room``) while the sum would pass the marginal share of the
    budget, and only what no eviction can fit raises. Returns {device:
    the batch's estimate without the programs, plus on a card one
    working stack for the pool of a program the render may still
    capture}: what a capture on that device must find room for
    (``_program``)."""
    if shares is None:
        shares = {device: 1}
    n = sum(shares.values())
    est_all, depth = _hbm_estimate_bytes(batch, window, post, max_inflight,
                                         working_bpp)
    # a program still to capture on a card keeps one more working stack:
    # its graph's pool (the CPU captures nothing)
    pool_all = int(working_bpp * batch * window.width * window.height)
    need = {}
    for dev, count in shares.items():
        est = int(est_all * count / n)
        need[dev] = est + (int(pool_all * count / n)
                           if dev.type == 'cuda' else 0)
        budget = _hbm_budget_bytes(dev)
        if not budget:        # None: the CPU; 0: switched off
            continue
        held = _make_room(dev, est)
        share = ('' if n == 1 else ', %d of %d frame shards on %s'
                 % (count, n, dev))
        if est + held > budget:
            raise ValueError(
                '%d frames at %dx%d estimate ~%.1f GiB on the device '
                '(%d retained output buffers%s%s%s%s) against a ~%.1f GiB '
                'HBM budget; the render would run out of memory part-way. '
                'Reduce batch, bound max_inflight, or override with '
                'CANVAS_HBM_MB (0 disables this check).'
                % (batch, window.width, window.height,
                   (est + held) / (1 << 30), depth,
                   ' + f32 working set' if working_bpp else '',
                   ' + the %s post\'s working set' % post if post else '',
                   ' + %.1f GiB of render programs' % (held / (1 << 30))
                   if held else '', share, budget / (1 << 30)))
        est += held
        if est > _MARGINAL * budget:
            _log.warning(
                'batch %d at %dx%d estimates ~%.1f GiB on the device%s '
                'against a ~%.1f GiB HBM budget: marginal; consider a '
                'smaller batch or max_inflight', batch, window.width,
                window.height, est / (1 << 30), share, budget / (1 << 30))
    return need


def _device_shares(mesh, axis):
    """{device: the frame shards it renders} of a split over *axis* of
    *mesh* (each shard on ``mesh.axis_devices(axis)``)."""
    shares = OrderedDict()
    for d in mesh.axis_devices(axis):
        shares[d] = shares.get(d, 0) + 1
    return shares


def _pinned_bytes(plists):
    """Device bytes the flat param lists *plists* keep alive: each
    tensor's storage counted once (per-batch views of one staged stack,
    or of one upload, share theirs), and each host array at the bytes
    its upload will take."""
    seen = {}
    for plist in plists:
        for p in plist:
            for v in p.values():
                for t in (v.copies.values() if isinstance(v, Replicated)
                          else (v,) if isinstance(v, torch.Tensor) else ()):
                    st = t.untyped_storage()
                    seen[(t.device, st.data_ptr())] = st.nbytes()
                if isinstance(v, np.ndarray):
                    seen[id(v)] = v.nbytes
    return sum(seen.values())


class _Prepared:
    """One prepared segment: the sliced signature (a shard's, over a
    mesh) and its batches ``(pos, n_valid)``, each with its flat params:
    on the host as planned, on the device from the batch's first
    dispatch on (``device_params``, or over a mesh ``shard_params``), so
    a cached plan replays with no copy."""

    __slots__ = ('seg_start', 'sig', 'ops', 'spans', 'plists', 'uploaded',
                 'family')

    def __init__(self, seg_start, sig, batches, ops=None, family=None):
        self.seg_start = seg_start
        self.sig = sig
        self.ops = ops
        #: the unsliced segment signature (``explain``'s program line)
        self.family = family
        self.spans = [(pos, take) for pos, take, _pl in batches]
        self.plists = [pl for _pos, _take, pl in batches]
        self.uploaded = [False] * len(batches)

    def device_params(self, i, device):
        """Batch *i*'s params on *device*: uploaded the first time
        (``params_to_torch``, on the calling thread's stream), and
        kept."""
        if not self.uploaded[i]:
            self.plists[i] = params_to_torch(self.plists[i], device)
            self.uploaded[i] = True
        return self.plists[i]

    def shard_params(self, i, devices):
        """Batch *i*'s params split over one shard per entry of
        *devices*, each shard's on its device: uploaded the first time
        (``params_to_shards``), and kept."""
        if not self.uploaded[i]:
            self.plists[i] = params_to_shards(self.plists[i], self.ops,
                                              devices)
            self.uploaded[i] = True
        return self.plists[i]


def _hits(counts, cache):
    """``explain``'s hit and miss counts of *cache*, a counter prefix."""
    return '%d hits, %d misses' % (counts.get(cache + '.hit', 0),
                                   counts.get(cache + '.miss', 0))


class RenderPlanner:
    """Plans frame ranges of *source* on the host and renders them on a
    torch device (the counterpart of ``canvas_tpu.render.RenderPlanner``).

    ``device=None`` is CUDA and raises when there is none;
    ``device='cpu'`` runs the kernels' plain PyTorch versions.
    ``iter_batches`` keeps each prepared segment (the plan cut into
    batches, their params on the device once dispatched) in a plan
    cache, so a replayed or looped range plans nothing and copies
    nothing (``plan_cache_segments``); ``render`` plans anew. Staged stacks
    (host-pulled frames, coded planes) live in ``persistent_cache``
    between calls; ``stage_cache_mb = 0`` turns both caches off.
    """

    #: The CUDA stream the render reads staged stacks on: the calling
    #: thread's current stream when ``iter_batches``/``render`` starts
    #: (None off CUDA). See ``staging.py``.
    render_stream = None

    #: Over a mesh, the stream of each of its CUDA devices that the
    #: shards read staged stacks on (None off CUDA or without a mesh).
    render_streams = None

    #: Device-byte budget for the persistent staging cache
    #: (CANVAS_STAGE_CACHE_MB env overrides; 0 disables).
    stage_cache_mb = None

    #: Most prepared segments kept across ``iter_batches`` calls (0
    #: disables). A cached plan pins its staged device stacks, so plans
    #: are not kept either when the staging budget is 0: a planner told
    #: to cache nothing on the device would else keep the stacks alive
    #: through its plans. Time a cold pass with this set to 0.
    plan_cache_segments = 64

    #: The cached plan of ``render_display``'s current segment (None
    #: until the first call; dropped by ``invalidate_display_cache``).
    _display_seg = None

    #: Device viewport-resample matrices by display size, an LRU of
    #: ``_DISPLAY_MATS_KEPT`` entries (``_display_matrices``).
    _display_mats = None

    #: Planning-span cap: structure segments longer than this split into
    #: chunks, which bounds host staging memory and the time to the first
    #: frame of a long export.
    max_plan_frames = 256

    #: Pipeline-chunk span: long segments also split into chunks of this
    #: many frames, so the prepare thread stages chunk k+1 while the
    #: device renders chunk k.
    pipeline_chunk = 64

    def __init__(self, source, window, quality=10, device=None):
        self.source = source
        self.window = box2i(window)
        #: Render-quality hint, the reference's 1-11 scale (10 = normal
        #: best, framework.h:510-513); quality >= 10 is bit-exact with
        #: the pull path.
        self.quality = int(quality)
        self.device = backend.resolve_device(device)
        backend.ensure_initialized()
        #: Prepared segments by (segment, batch, post, quality), least
        #: recently used first, each with the device bytes it pins; the
        #: prepare thread inserts while edits prune, under the lock.
        self._plan_cache = OrderedDict()
        self._plan_cache_lock = threading.Lock()

    def set_quality(self, quality):
        """Change the quality hint; drops cached plans and staged device
        data."""
        quality = int(quality)
        if quality != self.quality:
            self.quality = quality
            self.invalidate_display_cache()

    @property
    def persistent_cache(self):
        cache = getattr(self, '_persistent_cache', None)
        if cache is None:
            mb = self.stage_cache_mb
            if mb is None:
                mb = float(os.environ.get('CANVAS_STAGE_CACHE_MB', '1536'))
            cache = self._persistent_cache = StageLRU(mb * (1 << 20))
        return cache

    def _note_render_stream(self, mesh=None):
        if self.device.type == 'cuda':
            self.render_stream = torch.cuda.current_stream(self.device)
        self.render_streams = None
        if mesh is not None and mesh.devices.flat[0].type == 'cuda':
            self.render_streams = {d: torch.cuda.current_stream(d)
                                   for d in mesh.distinct_devices()}

    def _plan_context(self, seg, mesh=None):
        """A fresh ``PlanContext`` for segment [s0, s1), staging onto
        *mesh* when given; the per-segment staging state starts
        empty."""
        s0, s1 = seg
        self._stage_cache = {}
        self._frame_hints = {}
        frames = np.arange(s0, s1, dtype=np.int64)
        return PlanContext(self, frames, self.window, mesh=mesh)

    def _plan(self, seg):
        """Plan segment [s0, s1) on the host with the port's
        ``PlanContext`` (NumPy, plus the port's device staging), its
        region offsets checked (``check_placed``)."""
        return check_placed(self._plan_context(seg).plan(self.source))

    def explain(self, start, stop):
        """Human-readable plan report for [start, stop): per segment, the
        IR tree (op, static geometry, param shapes with ``@dev`` on
        tensors already on the device, per-frame window coverage), then
        the stage cache's and the plan cache's size with their hits and
        misses (``profiling``'s counters since its last ``reset``, every
        planner's). Each segment's line says whether a render program of
        it was captured on this planner's device and is live
        (render.py:1686-1692). Planning is real: it stages what a first
        render would, into the same caches."""
        lines = []
        area = float(self.window.width * self.window.height)

        def walk(n, depth):
            parts = [n.op]
            if n.static:
                parts.append('static=%r' % (n.static,))
            if n.params:
                ps = []
                for k in sorted(n.params):
                    v = n.params[k]
                    shape = tuple(np.shape(v) if not isinstance(
                        v, (torch.Tensor, Replicated)) else v.shape)
                    ps.append('%s%s%s' % (
                        k, shape if shape else '',
                        '@dev' if isinstance(v, (torch.Tensor, Replicated))
                        else ''))
                parts.append(' '.join(ps))
            if n.windows is not None and area:
                w = windows_to_array(n.windows)
                ww = np.maximum(w[:, 2] - w[:, 0] + 1, 0)
                hh = np.maximum(w[:, 3] - w[:, 1] + 1, 0)
                cov = float(np.mean(ww * hh)) / area
                parts.append('cover=%.0f%%' % (100.0 * cov))
            lines.append('  ' * (depth + 1) + '  '.join(parts))
            for c in n.children:
                walk(c, depth + 1)

        self._drain_plan_pool()
        device = _program_device(self.device)
        for (s0, s1) in self.segments(start, stop):
            node = self._plan((s0, s1))
            with _program_lock:
                captured = (signature(node), device) in _compiled_families
            lines.append('segment [%d, %d)  %d frames  program %s'
                         % (s0, s1, s1 - s0,
                            'CAPTURED' if captured else 'not captured'))
            walk(node, 0)
        cache = self.persistent_cache
        counts = {k: v[1] for k, v in profiling.report().items()}
        lines.append('stage cache: %d entries, %.1f MB of %.1f MB; %s'
                     % (len(cache), cache.bytes / 1e6, cache.budget / 1e6,
                        _hits(counts, 'render.stage_cache')))
        lines.append('plan cache: %d prepared segments; %s'
                     % (len(self._plan_cache),
                        _hits(counts, 'render.plan_cache')))
        return '\n'.join(lines)

    def segments(self, start, stop, min_span=0):
        """Split [start, stop) at graph-structure boundaries (and the
        planning-span/pipeline-chunk caps). Empty/reversed ranges are
        empty, not a zero-length segment. ``min_span`` raises the
        chunk cap so a caller's batch size is honored (still bounded by
        max_plan_frames, the memory cap)."""
        if stop <= start:
            return []
        span = min(self.max_plan_frames,
                   max(self.pipeline_chunk, min_span))
        cuts = sorted(set(
            c for c in self.source.plan_cuts(start, stop) if start < c < stop))
        edges = [start] + cuts + [stop]
        out = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            while hi - lo > span:
                out.append((lo, lo + span))
                lo += span
            out.append((lo, hi))
        return out

    def _prepare(self, seg, batch):
        """Plan one segment and cut its params into per-batch lists
        (render.py:1821-1901 without the device puts): returns
        (seg_start, signature, batches) with batches
        [(pos, n_valid, params)], the params still on the host."""
        return self._cut(seg, self._plan(seg), batch)

    def _cut(self, seg, node, batch, shards=1):
        """The planned *node* of *seg* as (seg_start, sliced signature,
        [(pos, n_valid, params)]). Tail batches repeat the last frame; a
        segment shorter than *batch* renders at its own length, rounded
        up to *shards* by repeating its last frame (render.py:1852-1880).
        Over *shards* frame shards the signature is one shard's: a
        batch's frames over the shard count."""
        seg_start, seg_stop = seg
        N = seg_stop - seg_start
        B_eff = batch if N >= batch else N + ((-N) % shards)
        sig = sliced_signature(node, N, B_eff // shards)
        params = flat_params(node)
        ops = node.flat_ops([])
        batches = []
        pos = 0
        while pos < N:
            take = min(batch, N - pos)
            if N < batch and B_eff == N:
                def cut(v, ax):
                    return v
            elif N < batch:
                idx_seg = np.concatenate([np.arange(N),
                                          np.full(B_eff - N, N - 1,
                                                  np.int64)])

                def cut(v, ax, idx=idx_seg):
                    return np.take(v, idx, axis=ax)
            elif take == batch:
                def cut(v, ax, pos=pos):
                    return v[(slice(None),) * ax + (slice(pos, pos + batch),)]
            else:
                idx = np.concatenate([np.arange(pos, N),
                                      np.full(batch - take, N - 1, np.int64)])

                def cut(v, ax, idx=idx):
                    return np.take(v, idx, axis=ax)
            batches.append((pos, take, [
                {k: (v if _param_sharding(op, k) is None
                     else cut(v, _param_sharding(op, k)))
                 for k, v in p.items()}
                for p, op in zip(params, ops)]))
            pos += take
        return seg_start, sig, batches

    def _prepared(self, seg, batch, post, cache_plans, mesh=None,
                  axis='frames'):
        """The ``_Prepared`` form of one segment (render.py:1821-1980):
        planned (staging onto *mesh* when given) and cut into batches.
        Runs on the prepare thread, one segment ahead, so host planning
        and staging overlap the device's work on the segment before.

        Prepared segments are kept per (segment, batch, post, quality,
        and over a mesh the mesh and axis) when *cache_plans*: a replayed
        range dispatches the cut batches again as they are, their params
        on the device since their first dispatch. The cache is an LRU
        bounded by ``plan_cache_segments`` and by the device bytes its
        entries pin (staged stacks and uploaded params, each storage
        once) against the staging cache's budget."""
        key = (seg, batch, post, self.quality)
        if mesh is not None:
            key += (mesh, axis)
        if cache_plans:
            with self._plan_cache_lock:
                got = self._plan_cache.get(key)
                if got is not None:
                    self._plan_cache.move_to_end(key)
                    profiling.count('render.plan_cache.hit')
                    return got[0]
            profiling.count('render.plan_cache.miss')
        ctx = self._plan_context(seg, mesh)
        with profiling.Timer('render.plan', seg):
            node = check_placed(ctx.plan(self.source))
        shards = mesh.shape[axis] if mesh is not None else 1
        with profiling.Timer('render.cut', seg):
            result = _Prepared(*self._cut(seg, node, batch, shards),
                               ops=node.flat_ops([]),
                               family=signature(node))
        if cache_plans:
            pinned = _pinned_bytes(result.plists)
            budget = self.persistent_cache.budget
            if pinned <= budget:
                with self._plan_cache_lock:
                    # An edit that invalidated mid-plan (gen moved since
                    # the PlanContext was made) must not insert the now
                    # stale plan. Checked under the lock: invalidation
                    # bumps gen BEFORE it prunes plans, so either this
                    # check fails or the prune runs after the insert and
                    # removes it.
                    if self.persistent_cache.gen != ctx.stage_gen:
                        return result
                    cache = self._plan_cache
                    cache[key] = (result, pinned)
                    total = sum(b for (_r, b) in cache.values())
                    while len(cache) > 1 and (
                            len(cache) > self.plan_cache_segments
                            or total > budget):
                        _k, (_r, b) = cache.popitem(last=False)
                        total -= b
        return result

    def iter_batches(self, start, stop, batch=16, device_out=True,
                     mesh=None, axis='frames', post=None,
                     max_inflight=None):
        """Yield ``(frame_start, n_valid, out)`` for [start, stop) in
        fixed-size batches: ``out`` a (B, 4, H, W) f16 tensor on the
        device (a numpy array with ``device_out=False``). The tail batch
        of a segment repeats its last frame and reports
        ``n_valid < batch``; ``out`` is cut to the valid frames.

        ``post`` converts each batch on the device for export
        (render.py:1445-1489): 'rgba_u8' / 'bgra_u8' give (B, H, W*4)
        interleaved u8 through the gamma45 ramp, 'yuv420' gives
        (B, H*W + 2*ceil(H/2)*ceil(W/2)) packed studio-range 4:2:0 u8.

        With *mesh* (a ``mesh.Mesh``), each batch's frames split over its
        *axis* (render.py:1784-1804): *batch* must divide by
        ``mesh.shape[axis]``, shard i renders frames [i*b, (i+1)*b) of
        the batch on ``mesh.axis_devices(axis)[i]`` (inside
        ``torch.cuda.device`` of that card), with its frame params and the
        replicated ones uploaded there in one packed copy, and ``out`` is
        a ``mesh.ShardedFrames`` (one host array with
        ``device_out=False``). Staged stacks are replicated onto every
        distinct device of the mesh. A segment shorter than the batch
        renders at its length rounded up to the shard count, repeating
        its last frame.

        ``max_inflight`` bounds how many batches may be launched and not
        yet finished on the device (render.py:1982-2033): after each
        batch's last launch a CUDA event is recorded on the current
        stream of each device the batch ran on, and before launching
        past depth k the host waits for the oldest batch's events, so it
        still runs k batches ahead. None or a non-positive value is
        unbounded. With ``device_out=False`` each batch's fetch already
        paces the host, and off CUDA every op is synchronous: nothing is
        recorded.

        Each structure segment is prepared once, one segment ahead, on a
        worker thread (planning and staging); each batch's params go to
        the device in one packed copy (one a shard), and its render
        program (``_get_program``: one CUDA graph per signature and
        device, captured at its second batch) replays, on the calling
        thread. Every ``out`` is a fresh tensor the caller owns.
        Prepared segments are kept for the next call with the params
        they uploaded (``plan_cache_segments``), keyed by the mesh and
        axis too. One live iterator per planner:
        the prepare thread shares the planner's staging state."""
        devices = shares = None
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError('mesh must be a canvas_tpu_torch.mesh.Mesh, '
                                'not %r' % (mesh,))
            if axis not in mesh.shape:
                raise ValueError('mesh %r has no axis %r' % (mesh, axis))
            if batch % mesh.shape[axis] != 0:
                raise ValueError('batch %d not divisible by %d shards'
                                 % (batch, mesh.shape[axis]))
            devices = mesh.axis_devices(axis)
            shares = _device_shares(mesh, axis)
        if post is not None and post not in color_ops.POSTS:
            raise ValueError('post must be one of %s, not %r'
                             % (sorted(color_ops.POSTS), post))
        if max_inflight is not None and max_inflight <= 0:
            max_inflight = None
        with profiling.Timer('render.pass_start'):
            need = _check_hbm_footprint(batch, self.window, post,
                                        max_inflight, self.device,
                                        shares=shares)
            # Plans pin staged device stacks: no staging budget, no plan
            # cache either (a cold staging measurement sets
            # stage_cache_mb = 0 and relies on it disabling BOTH).
            cache_plans = (self.plan_cache_segments > 0
                           and self.persistent_cache.budget > 0)
            ran_on = (list(dict.fromkeys(devices)) if devices is not None
                      else [self.device])
            pending = (deque() if max_inflight and device_out
                       and ran_on[0].type == 'cuda' else None)
            segs = self.segments(start, stop, min_span=batch)
            self._drain_plan_pool()
            self._watch_frames_updated()
            self._note_render_stream(mesh)
            pool = self._plan_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix='canvas-torch-plan')
            # a pool that never gets here is shut down by the next
            # pass's _drain_plan_pool
            fut = (pool.submit(self._prepared, segs[0], batch, post,
                               cache_plans, mesh, axis) if segs else None)
        try:
            for i, seg in enumerate(segs):
                with profiling.Timer('render.prepare_wait', seg):
                    prepared = fut.result()
                if i + 1 < len(segs):
                    fut = pool.submit(self._prepared, segs[i + 1], batch,
                                      post, cache_plans, mesh, axis)
                with profiling.Timer('render.dispatch', seg):
                    if devices is None:
                        program = _get_program(prepared.sig, self.device,
                                               post, need[self.device],
                                               prepared.family)
                    else:
                        programs = _get_sharded_program(
                            prepared.sig, devices, post, need,
                            prepared.family)
                for k, (pos, take) in enumerate(prepared.spans):
                    if pending is not None and len(pending) >= max_inflight:
                        # the oldest pending batch: each stream runs in
                        # order, so everything older has finished too
                        with profiling.Timer('render.inflight_wait'):
                            for done in pending.popleft():
                                done.synchronize()
                    # A cached plan keeps its params on the device (one
                    # device copy into the program a batch); otherwise the
                    # host params go straight into the program's buffer.
                    with profiling.Timer('render.dispatch', seg):
                        if devices is None:
                            with _on(self.device):
                                out = program(
                                    prepared.device_params(k, self.device)
                                    if cache_plans else prepared.plists[k])
                        else:
                            out = self._run_shards(
                                prepared.sig,
                                prepared.shard_params(k, devices)
                                if cache_plans
                                else _split_shards(prepared.plists[k],
                                                   prepared.ops, devices),
                                devices, mesh, axis, post, programs)
                    if pending is not None:
                        events = []
                        for d in ran_on:
                            done = torch.cuda.Event()
                            done.record(torch.cuda.current_stream(d))
                            events.append(done)
                        pending.append(events)
                    if take < out.shape[0]:
                        out = out[:take]
                    if not device_out:
                        out = backend.to_host(out).numpy()
                    yield prepared.seg_start + pos, take, out
        finally:
            pool.shutdown(wait=False)
            if getattr(self, '_plan_pool', None) is pool:
                self._plan_pool = None

    @staticmethod
    def _run_shards(sig, shard_params, devices, mesh, axis, post,
                    programs=None):
        """Render one batch's shards, each on its device through its
        program (``_get_sharded_program``), as one ``ShardedFrames`` whose
        shard i holds frames [i*b, (i+1)*b)."""
        if programs is None:
            programs = _get_sharded_program(sig, devices, post)
        outs = []
        for device, params, program in zip(devices, shard_params, programs):
            with _on(device):
                outs.append(program(params))
        b = outs[0].shape[0]
        shape = (b * len(outs),) + tuple(outs[0].shape[1:])
        spec = (axis,) + (None,) * (len(shape) - 1)
        return ShardedFrames(
            [(o, (slice(i * b, (i + 1) * b),)) for i, o in enumerate(outs)],
            shape, outs[0].dtype, Sharding(mesh, spec))

    def render(self, start, stop, device_out=False, with_windows=False):
        """Render frames [start, stop) as (B, 4, H, W) f16: a numpy
        array, or the device tensor with ``device_out=True``. With
        ``with_windows=True`` returns ``(data, windows)``, windows the
        per-frame current_window as a (B, 4) int64 [x0, y0, x1, y1]
        array (empty encoded max < min). Each segment renders through
        its program (``_get_program`` of its signature), its params in one
        packed copy."""
        self._drain_plan_pool()
        self._watch_frames_updated()
        self._note_render_stream()
        # Every segment's output stays in `outs` until the concatenation,
        # which holds a second buffer of the whole size: the footprint of
        # a range of several segments is the whole range's.
        _check_hbm_footprint(stop - start, self.window, None, 2, self.device,
                             working_bpp=0)
        outs = []
        windows = []
        for seg in self.segments(start, stop):
            # one segment renders at a time, its output kept: depth 1
            need = _check_hbm_footprint(seg[1] - seg[0], self.window, None,
                                        1, self.device)
            node = self._plan(seg)
            sig = signature(node)
            program = _get_program(sig, self.device,
                                   reserve=need[self.device], family=sig)
            with _on(self.device):
                outs.append(program(flat_params(node)))
            windows.append(windows_to_array(node.windows))
        if outs:
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
            wins = np.concatenate(windows, axis=0)
        else:
            out = torch.zeros((0, 4, self.window.height, self.window.width),
                              dtype=torch.float16, device=self.device)
            wins = np.zeros((0, 4), np.int64)
        if not device_out:
            out = backend.to_host(out).numpy()
        return (out, wins) if with_windows else out

    def render_display(self, frame_index, order=(2, 1, 0, 3), intent=None,
                       display_size=None, transport='u8'):
        """Low-latency single-frame display pull (render.py:2105-2241):
        the frame is rendered AND converted to u8 on the device, and only
        display bytes cross to the host, in one copy. Returns an
        (h, w, 4) uint8 array in channel *order* (default BGRA).

        ``intent=None`` uses the gamma45 ramp (the to_argb_string
        contract, gammatab.c:12-37); a float uses the widget_gl soft
        mode, the sRGB transfer then that rendering intent
        (widget_gl.c:291-308, 1.25 there by default).

        ``display_size=(w, h)`` resamples the composite to the viewport
        on the device before the conversion (linear-light triangle
        filter, ``display_matrices_host``), so only w*h pixels cross.

        ``transport``: 'u8' fetches the channels of *order*; 'rgb24'
        (lossless) only the three color channels, alpha padded to 255 on
        the host; 'yuv420' (lossy, preview only) full-range BT.601 Y and
        2x2-mean Cb/Cr, 1.5 bytes/px, unpacked on the host with alpha
        255.

        Scrub-friendly: the pipeline-chunk segment holding the frame is
        planned once and its params go to the device once; later frames
        of the segment slice their params out of those tensors, which the
        display program (``_get_display_program``: one CUDA graph per
        one-frame signature, order, intent, display size and transport)
        copies into its slots on the device, and whose finish fetches the
        u8 bytes. Edits
        drop the cached segment through the source's ``frames_updated``
        signal (subscribed automatically) or
        ``invalidate_display_cache()``."""
        if transport not in DISPLAY_TRANSPORTS:
            raise ValueError('transport must be one of %s, not %r'
                             % (DISPLAY_TRANSPORTS, transport))
        order = tuple(int(c) for c in order)
        frame_index = int(frame_index)
        seg = self._display_seg
        if seg is None or not seg['lo'] <= frame_index < seg['hi']:
            seg = self._plan_display_seg(frame_index)
        if display_size is not None:
            display_size = (int(display_size[0]), int(display_size[1]))
        pos = frame_index - seg['lo']
        # views of the frame's params: the program's slots copy them
        params = [{k: (v if _param_sharding(op, k) is None
                       else v[(slice(None),) * _param_sharding(op, k)
                              + (slice(pos, pos + 1),)])
                   for k, v in p.items()}
                  for p, op in zip(seg['params'], seg['ops'])]
        mats = self._display_matrices(display_size)
        if mats is not None:
            params.append({'dy': mats[0], 'dx': mats[1]})
        program = _get_display_program(
            seg['sig1'], self.device, order,
            None if intent is None else float(intent), display_size,
            transport, seg['need'], seg['family'])
        with _on(self.device):
            flat = program(params)
        if transport == 'yuv420':
            dw, dh = display_size or (self.window.width, self.window.height)
            return color_ops.yuv420_unpack_batch(flat, dh, dw, order)[0]
        if transport == 'rgb24':
            return color_ops.rgb24_unpack(flat[0], order)
        # a copy: the fetched bytes sit in pinned memory, which is not
        # for the caller to keep
        return flat.numpy().reshape(flat.shape[1], -1, len(order)).copy()

    def _plan_display_seg(self, frame_index):
        """Plan the pipeline-chunk segment holding *frame_index* once and
        put its params on the device (render.py:2156-2180)."""
        self._drain_plan_pool()
        self._watch_frames_updated()
        self._note_render_stream()
        chunk = self.pipeline_chunk
        lo0 = (frame_index // chunk) * chunk
        lo, hi = next((s0, s1) for s0, s1 in self.segments(lo0, lo0 + chunk)
                      if s0 <= frame_index < s1)
        node = self._plan((lo, hi))
        seg = self._display_seg = {
            'lo': lo, 'hi': hi,
            'params': params_to_torch(flat_params(node), self.device),
            'ops': node.flat_ops([]),
            'sig1': sliced_signature(node, hi - lo, 1),
            'family': signature(node),
            'need': _check_hbm_footprint(1, self.window, None, 1,
                                         self.device)[self.device],
        }
        return seg

    def _display_matrices(self, display_size):
        """(Dy (dh, H), Dx (dw, W)) viewport-resample matrices for this
        planner's window on its device, kept per size in an LRU of
        ``_DISPLAY_MATS_KEPT`` (render.py:2243-2266); None for a
        full-size display."""
        if display_size is None:
            return None
        display_size = (int(display_size[0]), int(display_size[1]))
        cache = self._display_mats
        if cache is None:
            cache = self._display_mats = OrderedDict()
        got = cache.get(display_size)
        if got is not None:
            cache.move_to_end(display_size)
            return got
        # interactive resizes sweep through many sizes; each pair is a
        # few MB on the device
        while len(cache) >= _DISPLAY_MATS_KEPT:
            cache.popitem(last=False)
        Dy, Dx = display_matrices_host(self.window.height, self.window.width,
                                       display_size)
        got = cache[display_size] = (backend.to_device(Dy, self.device),
                                     backend.to_device(Dx, self.device))
        return got

    def invalidate_display_cache(self, *args):
        """Drop the cached display segment, cached plans and staged
        device data (the graph changed).

        Sources edited through a signal-bearing layer call this through
        their ``frames_updated`` signal; code that mutates a raw graph
        directly must call it, or use a fresh planner, before rendering
        again. With a frame range (``frames_updated(lo, hi)``, hi
        inclusive), a display segment outside it, prepared plans of
        segments outside it (they keep replaying with no planning) and
        staged stacks that only ever served root segments outside it
        stay; without one, everything drops (render.py:2288-2322)."""
        # bools are ints in Python: a trailing positional flag must not
        # read as the range's end
        ints = [a for a in args
                if isinstance(a, (int, np.integer))
                and not isinstance(a, (bool, np.bool_))]
        lo = hi = None
        if len(ints) >= 2:
            lo, hi = int(ints[-2]), int(ints[-1])
        seg = self._display_seg
        if seg is not None and (lo is None
                                or (seg['lo'] <= hi and lo < seg['hi'])):
            self._display_seg = None
        # The stage cache first: it bumps its generation, which the plan
        # cache's insert checks under the lock taken below.
        cache = self.persistent_cache
        if lo is None:
            cache.clear()
        else:
            cache.invalidate_range(lo, hi)
        with self._plan_cache_lock:
            plans = self._plan_cache
            if lo is None:
                plans.clear()
            else:
                for key in [k for k in plans
                            if k[0][0] <= hi and lo < k[0][1]]:
                    del plans[key]

    def _watch_frames_updated(self):
        if getattr(self, '_watching_updates', False):
            return
        updated = getattr(self.source, 'frames_updated', None)
        if updated is not None:
            updated.connect(self.invalidate_display_cache)
        self._watching_updates = True

    def _drain_plan_pool(self):
        """Wait out an abandoned iterator's in-flight prepare thread (it
        mutates the planner's per-segment staging state) before anything
        else touches those fields."""
        pool = getattr(self, '_plan_pool', None)
        if pool is not None:
            self._plan_pool = None
            pool.shutdown(wait=True, cancel_futures=True)

    def close(self):
        """Deterministic teardown: disconnect from the source's
        frames_updated signal and drop the display segment, cached plans,
        staged stacks and viewport matrices."""
        self._drain_plan_pool()
        if getattr(self, '_watching_updates', False):
            updated = getattr(self.source, 'frames_updated', None)
            if updated is not None:
                updated.disconnect(self.invalidate_display_cache)
            self._watching_updates = False
        self.invalidate_display_cache()
        self._stage_cache = {}
        if self._display_mats is not None:
            self._display_mats.clear()


def render_frames(source, window, start, stop, device=None, **kw):
    """One-call batched render of frames [start, stop) (see
    :class:`RenderPlanner`; *device* None is CUDA)."""
    planner = RenderPlanner(source, window, device=device)
    try:
        return planner.render(start, stop, **kw)
    finally:
        planner.close()


def render_sharded(source, window, start, stop, mesh=None, axis='frames',
                   device_out=False, spatial_axis=None, batch=None):
    """Frame-parallel batched render of [start, stop) across a device
    mesh (render.py:2392-2460): a collector over
    ``RenderPlanner.iter_batches(mesh=, axis=)``, so every segment renders
    sharded, a frame count that does not divide the shards pads with its
    last frame and is cut back, and ``device_out`` holds across segment
    cuts.

    *mesh* (a ``mesh.Mesh``) defaults to ``mesh.local_mesh(axis)``, every
    visible card. A mesh of one entry along *axis* streams unsharded (no
    sharded dispatch for no parallelism) unless *spatial_axis* asks for
    the mesh. *batch* defaults to the planner's pipeline chunk; either is
    rounded down to a multiple of the shard count. The whole range's
    output is held until it is assembled, so the memory guard checks it
    cumulatively (two buffers a frame, no working set), each device with
    its share of the frame shards.

    Returns a (F, 4, H, W) f16 NumPy array, or with ``device_out`` the
    frames on the devices: unsharded, one tensor; sharded, a
    ``ShardedFrames`` of one contiguous frame block per entry along
    *axis* (``NamedSharding(mesh, P(axis))``). *spatial_axis*, a second
    axis of the mesh, also splits the rows: block (i, j), frame block i
    and row block j, ends on the device at index i of *axis* and j of
    *spatial_axis* (peer copies between cards; the JAX package's XLA
    all-to-all); a frame count that does not divide the frames axis
    pads with its last frame and is sliced back."""
    if mesh is None:
        mesh = local_mesh(axis)
    elif not isinstance(mesh, Mesh):
        raise TypeError('mesh must be a canvas_tpu_torch.mesh.Mesh, not %r'
                        % (mesh,))
    if axis not in mesh.shape or (spatial_axis is not None
                                  and spatial_axis not in mesh.shape):
        raise ValueError('mesh %r lacks axis %r or %r'
                         % (mesh, axis, spatial_axis))
    n = mesh.shape[axis]
    use_mesh = mesh if (n > 1 or spatial_axis is not None) else None
    planner = RenderPlanner(source, window, device=mesh.devices.flat[0])
    try:
        _check_hbm_footprint(
            stop - start, planner.window, None, 2, planner.device,
            working_bpp=0,
            shares=(_device_shares(mesh, axis) if use_mesh is not None
                    else None))
        if batch is None:
            batch = n * max(1, planner.pipeline_chunk // n)
        else:
            batch = n * max(1, batch // n)
            planner.pipeline_chunk = max(planner.pipeline_chunk, batch)
        outs = [out for (_s, _n, out) in planner.iter_batches(
            start, stop, batch=batch, device_out=True, mesh=use_mesh,
            axis=axis)]
    finally:
        planner.close()
    if use_mesh is None or not outs:
        if outs:
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        else:
            out = torch.zeros((0, 4, planner.window.height,
                               planner.window.width), dtype=torch.float16,
                              device=planner.device)
        return out if device_out else backend.to_host(out).numpy()
    whole = ShardedFrames.concatenate(outs)
    if spatial_axis is None and not device_out:
        return whole.numpy()
    out = whole.reshard(mesh, axis, spatial_axis)
    return out if device_out else out.numpy()


def _frame_slice(v, ax, pos):
    """Frame *pos* of a segment param along its frame axis *ax*, as a
    one-frame param: a contiguous device tensor (the kernels take no
    strided input), cut from the segment's tensor on the device."""
    v = v[(slice(None),) * ax + (slice(pos, pos + 1),)]
    return v.contiguous() if isinstance(v, torch.Tensor) else v
