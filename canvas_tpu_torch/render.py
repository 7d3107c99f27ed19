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
``stage_rows``, ``dv_recon``, ``dv_recon_rows``, and the color filter's
``transfer`` and ``matrix``; the export conversions of ``iter_batches(post=...)``;
and the editor's display pull, ``render_display``, with its viewport
resample and its u8, rgb24 and yuv420 transports. Every other op raises
``NotImplementedError`` naming the ROADMAP.md queue item that ports it.
"""

import functools
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from canvas_tpu_torch import backend
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ir import (_BATCH_AXIS, _frame_params, flat_params,
                                 signature, sliced_signature,
                                 windows_to_array)
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.ops import cuda_ops
from canvas_tpu_torch.ops import scale as scale_ops
from canvas_tpu_torch.plan import PlanContext, StageLRU

__all__ = ['RenderPlanner', 'box2i', 'display_matrices_host', 'flat_params',
           'params_to_torch', 'run', 'signature', 'sliced_signature']

#: The transports of ``RenderPlanner.render_display``.
DISPLAY_TRANSPORTS = ('u8', 'rgb24', 'yuv420')

#: Viewport sizes whose device resample matrices a planner keeps.
_DISPLAY_MATS_KEPT = 8

#: Ops of the IR that the slice does not evaluate yet, with the
#: ROADMAP.md queue-1 item that ports each together with its only
#: emitter; the port has no source that plans any of them.
_LATER = {
    'field_interleave': 'queue 1 item 6a',
    'planar_recon_rows': 'queue 1 item 6a',
    'u8_linearize': 'queue 1 item 10',
    'solid_cells': 'queue 1 item 9 (not ported)',
}

#: Params kept as host Python ints: the region offsets. On the device
#: they would force a sync before every region launch.
_HOST_INT_PARAMS = frozenset(('dy0', 'dx0'))


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


def params_to_torch(plist, device):
    """The planner's flat param list (one dict per node, depth first; the
    same list ``Node.flat_params`` gives ``canvas_tpu.render._eval``) as
    tensors on *device*. Region offsets stay host ints; tensors already
    made by the planner (the staged stacks, on *device*) pass through."""
    out = []
    for p in plist:
        out.append({k: (int(v) if k in _HOST_INT_PARAMS
                        else v if isinstance(v, torch.Tensor)
                        else backend.to_device(_canonical(v), device))
                    for k, v in p.items()})
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


def _dv_recon_math(y8, cb8, cr8, U, M):
    """DV 4:1:1 reconstruction (render.py:1247-1267): studio-range
    expand, chroma upsample as a matmul with U (720, 180), the 3x3
    YCbCr->RGB matrix, the truncating f16 grid, rec709->linear."""
    y = (y8.float() - 16.0) / 219.0
    cb = (cb8.float() - 128.0) / 224.0
    cr = (cr8.float() - 128.0) / 224.0
    cb_full = torch.einsum('bhs,xs->bhx', cb, U)
    cr_full = torch.einsum('bhs,xs->bhx', cr, U)
    ycc = torch.stack([y, cb_full, cr_full], dim=1)
    rgb = torch.einsum('ij,bjhw->bihw', M, ycc)
    alpha = torch.ones_like(y)[:, None]
    rgba16 = color_ops.quantize_f16_trunc(torch.cat([rgb, alpha], dim=1))
    return color_ops.device_transfer('rec709_to_linear_scene', rgba16)


def _eval(node_sig, params_iter, device, out_dtype=torch.float32):
    """Rebuild the computation from the structure signature on *device*,
    visiting nodes in the depth-first order of ``Node.flat_params``.
    Each op follows the matching branch of ``canvas_tpu.render._eval``
    (render.py:786-1127). An ``over_stack`` at the root whose last child
    is a solid run finalizes straight to *out_dtype*, which ``run`` sets
    to f16 (the root's f16 store folded into the kernel); everything else
    is f32."""
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
        return _dv_recon_math(torch.index_select(params['py'], 0, rows),
                              torch.index_select(params['pcb'], 0, rows),
                              torch.index_select(params['pcr'], 0, rows),
                              params['up'], params['m'])

    if op == 'dv_recon':
        return _dv_recon_math(params['y'], params['cb'], params['cr'],
                              params['up'], params['m'])

    if op == 'transfer':
        # a named curve on all four channels, by the f16 bits of the child
        # rounded to the f16 grid (render.py:1142-1147)
        child = _eval(child_sigs[0], params_iter, device)
        return color_ops.device_transfer(static[0],
                                         color_ops.quantize_f16(child))

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


def _over_stack(static, child_sigs, params_iter, device, out_dtype):
    """Premultiplied-alpha fold of the children (render.py:869-1015).
    Solid runs fold through the ``solid_fold`` kernel (the last one
    finalizes straight to *out_dtype*); each placed rank-1 region
    composites through ``region_over_sep`` in place, any other placed
    region layer through ``region_over`` in place; any other child is a
    layer blended with torch ops.

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
    for i, cs in enumerate(child_sigs):
        c_op = cs[0]
        if c_op == 'solid_stack':
            c_params = next(params_iter)
            if P is not None:
                P, A = P.contiguous(), A.contiguous()
            if i == len(child_sigs) - 1:
                return cuda_ops.solid_fold(
                    P, A, c_params['color'], c_params['box'],
                    c_params['gain'], c_params['offset'], H, W,
                    finalize=True, out_dtype=out_dtype)
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
                color, ry, rx = _scale_solid_factors(inner[0], inner[1],
                                                     next(params_iter))
                layer = None
                B = color.shape[0]
            else:
                layer = _eval(inner, params_iter, device).contiguous()
                B = layer.shape[0]
            if P is None:
                P = torch.zeros((B, 3, H, W), dtype=acc_dt, device=device)
                A = torch.zeros((B, 1, H, W), dtype=acc_dt, device=device)
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
    P, A = P.float(), A.float()
    nz = A != 0.0
    rgb = torch.where(nz, P / torch.where(nz, A, 1.0), 0.0)
    return torch.cat([rgb, A], dim=1)


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


class RenderPlanner:
    """Plans frame ranges of *source* on the host and renders them on a
    torch device (the counterpart of ``canvas_tpu.render.RenderPlanner``).

    ``device=None`` is CUDA and raises when there is none;
    ``device='cpu'`` runs the kernels' plain PyTorch versions. Plans are
    not cached across calls: every ``iter_batches``/``render`` plans its
    segments anew. Staged stacks (host-pulled frames, coded planes) live
    in ``persistent_cache`` between calls; ``stage_cache_mb = 0`` turns
    that off.
    """

    #: The CUDA stream the render reads staged stacks on: the calling
    #: thread's current stream when ``iter_batches``/``render`` starts
    #: (None off CUDA). See ``staging.py``.
    render_stream = None

    #: The mesh the staged stacks target: None until multi-device is
    #: ported (ROADMAP.md queue 1 item 8).
    _plan_mesh = None

    #: Device-byte budget for the persistent staging cache
    #: (CANVAS_STAGE_CACHE_MB env overrides; 0 disables).
    stage_cache_mb = None

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

    def set_quality(self, quality):
        """Change the quality hint; drops staged device data."""
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

    def _note_render_stream(self):
        if self.device.type == 'cuda':
            self.render_stream = torch.cuda.current_stream(self.device)

    def _plan(self, seg):
        """Plan segment [s0, s1) on the host with the port's
        ``PlanContext`` (NumPy, plus the port's device staging)."""
        s0, s1 = seg
        self._stage_cache = {}
        self._frame_hints = {}
        frames = np.arange(s0, s1, dtype=np.int64)
        return PlanContext(self, frames, self.window).plan(self.source)

    def explain(self, start, stop):
        """Human-readable plan report for [start, stop): per segment, the
        IR tree (op, static geometry, param shapes with ``@dev`` on
        tensors already on the device, per-frame window coverage), then
        the stage cache's size. Planning is real: it stages what a first
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
                        v, torch.Tensor) else v.shape)
                    ps.append('%s%s%s' % (
                        k, shape if shape else '',
                        '@dev' if isinstance(v, torch.Tensor) else ''))
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
        for (s0, s1) in self.segments(start, stop):
            node = self._plan((s0, s1))
            lines.append('segment [%d, %d)  %d frames' % (s0, s1, s1 - s0))
            walk(node, 0)
        cache = self.persistent_cache
        lines.append('stage cache: %d entries, %.1f MB of %.1f MB'
                     % (len(cache), cache.bytes / 1e6, cache.budget / 1e6))
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
        (render.py:1821-1901 without the device puts). Runs on the
        prepare thread; returns (seg_start, signature, batches) with
        batches [(pos, n_valid, params)]. Tail batches repeat the last
        frame; a segment shorter than *batch* renders at its own
        length."""
        seg_start, seg_stop = seg
        node = self._plan(seg)
        N = seg_stop - seg_start
        B_eff = batch if N >= batch else N
        sig = sliced_signature(node, N, B_eff)
        params = flat_params(node)
        ops = node.flat_ops([])
        batches = []
        pos = 0
        while pos < N:
            take = min(batch, N - pos)
            if N < batch:
                def cut(v, ax):
                    return v
            elif take == batch:
                def cut(v, ax, pos=pos):
                    return v[(slice(None),) * ax + (slice(pos, pos + batch),)]
            else:
                idx = np.concatenate([np.arange(pos, N),
                                      np.full(batch - take, N - 1, np.int64)])

                def cut(v, ax, idx=idx):
                    return np.take(v, idx, axis=ax)
            batches.append((pos, take, [
                {k: (cut(v, _BATCH_AXIS.get(op, 0))
                     if k in _frame_params(op) else v)
                 for k, v in p.items()}
                for p, op in zip(params, ops)]))
            pos += take
        return seg_start, sig, batches

    def iter_batches(self, start, stop, batch=16, device_out=True,
                     mesh=None, post=None, max_inflight=None):
        """Yield ``(frame_start, n_valid, out)`` for [start, stop) in
        fixed-size batches: ``out`` a (B, 4, H, W) f16 tensor on the
        device (a numpy array with ``device_out=False``). The tail batch
        of a segment repeats its last frame and reports
        ``n_valid < batch``; ``out`` is cut to the valid frames.

        ``post`` converts each batch on the device for export
        (render.py:1445-1489): 'rgba_u8' / 'bgra_u8' give (B, H, W*4)
        interleaved u8 through the gamma45 ramp, 'yuv420' gives
        (B, H*W + 2*ceil(H/2)*ceil(W/2)) packed studio-range 4:2:0 u8.

        Each structure segment is planned once, one segment ahead, on a
        worker thread; host-to-device copies and launches happen on the
        calling thread. ``mesh`` and ``max_inflight`` are not ported yet
        (ROADMAP.md queue 1 items 8 and 6b) and must be None."""
        for name, value, item in (('mesh', mesh, 'queue 1 item 8'),
                                  ('max_inflight', max_inflight,
                                   'queue 1 item 6b')):
            if value is not None:
                raise _not_ported('iter_batches(%s=...)' % (name,), item)
        if post is not None and post not in color_ops.POSTS:
            raise ValueError('post must be one of %s, not %r'
                             % (sorted(color_ops.POSTS), post))
        segs = self.segments(start, stop, min_span=batch)
        self._drain_plan_pool()
        self._watch_frames_updated()
        self._note_render_stream()
        pool = self._plan_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='canvas-torch-plan')
        try:
            fut = pool.submit(self._prepare, segs[0], batch) if segs else None
            for i in range(len(segs)):
                seg_start, sig, batches = fut.result()
                if i + 1 < len(segs):
                    fut = pool.submit(self._prepare, segs[i + 1], batch)
                for (pos, take, cut_params) in batches:
                    out = run(sig, params_to_torch(cut_params, self.device),
                              self.device, post)
                    if take < out.shape[0]:
                        out = out[:take]
                    if not device_out:
                        out = out.cpu().numpy()
                    yield seg_start + pos, take, out
        finally:
            pool.shutdown(wait=False)
            if getattr(self, '_plan_pool', None) is pool:
                self._plan_pool = None

    def render(self, start, stop, device_out=False, with_windows=False):
        """Render frames [start, stop) as (B, 4, H, W) f16: a numpy
        array, or the device tensor with ``device_out=True``. With
        ``with_windows=True`` returns ``(data, windows)``, windows the
        per-frame current_window as a (B, 4) int64 [x0, y0, x1, y1]
        array (empty encoded max < min)."""
        self._drain_plan_pool()
        self._watch_frames_updated()
        self._note_render_stream()
        outs = []
        windows = []
        for seg in self.segments(start, stop):
            node = self._plan(seg)
            outs.append(run(signature(node),
                            params_to_torch(flat_params(node), self.device),
                            self.device))
            windows.append(windows_to_array(node.windows))
        if outs:
            out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
            wins = np.concatenate(windows, axis=0)
        else:
            out = torch.zeros((0, 4, self.window.height, self.window.width),
                              dtype=torch.float16, device=self.device)
            wins = np.zeros((0, 4), np.int64)
        if not device_out:
            out = out.cpu().numpy()
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
        of the segment slice their params out of those tensors. Edits
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
        params = [{k: (_frame_slice(v, _BATCH_AXIS.get(op, 0), pos)
                       if k in _frame_params(op) else v)
                   for k, v in p.items()}
                  for p, op in zip(seg['params'], seg['ops'])]
        flat = backend.to_host(display_run(
            seg['sig1'], params, self.device,
            self._display_matrices(display_size), order,
            None if intent is None else float(intent), transport))
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
        """Drop the cached display segment and staged device data (the
        graph changed).

        Sources edited through a signal-bearing layer call this through
        their ``frames_updated`` signal; code that mutates a raw graph
        directly must call it, or use a fresh planner, before rendering
        again. With a frame range (``frames_updated(lo, hi)``, hi
        inclusive), a display segment outside it and staged stacks that
        only ever served root segments outside it stay; without one,
        everything drops (render.py:2288-2308)."""
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
        cache = getattr(self, '_persistent_cache', None)
        if cache is None:
            return
        if lo is None:
            cache.clear()
        else:
            cache.invalidate_range(lo, hi)

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
        frames_updated signal and drop the display segment, staged stacks
        and viewport matrices."""
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


def _frame_slice(v, ax, pos):
    """Frame *pos* of a segment param along its frame axis *ax*, as a
    one-frame param: a contiguous device tensor (the kernels take no
    strided input), cut from the segment's tensor on the device."""
    v = v[(slice(None),) * ax + (slice(pos, pos + 1),)]
    return v.contiguous() if isinstance(v, torch.Tensor) else v
