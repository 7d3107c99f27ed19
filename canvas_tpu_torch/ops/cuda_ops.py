"""Hand-written CUDA kernels of the batched render path, each beside its
plain PyTorch version (the counterpart of ``canvas_tpu/ops/pallas_ops.py``).

Public names and argument orders follow ``pallas_ops`` without its
leading ``jnp, jax`` arguments. Boxes are int32 ``[y0, y1, x0, x1]``,
inclusive and relative to the frame; ``y1 < y0`` encodes an empty box.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (``canvas_tpu_torch/csrc/``,
built on first use by ``ops._build``) or raises. Nothing falls back
from the kernel to the plain version.

Each kernel has two forms: f32 accumulators (quality 10) and the
quality <= 9 tier's bf16 ones (pallas_ops.py:135-138, 193-196, 334-343:
the pass-boundary (P, A), and ``region_over``'s layer, are stored as
bf16 while the math stays f32). The form follows the dtypes of the
tensors passed. Each wrapper counts its launches in plain integer
attributes, one per form (``solid_fold.launches`` and
``solid_fold.launches_bf16``, likewise for ``region_over_sep`` and
``region_over``), so a run can show that its path went through each.

``solid_fold`` and ``region_over_sep`` each have two instantiations of
one template: one that moves 16 bytes a thread, for rows of a multiple
of 8 values in planes that start at a multiple of 16 bytes, and a
scalar one for everything else. ``_vector_ok`` chooses from the row
length and the tensors' pointers; ``launches_vector`` and
``launches_scalar`` count which one ran. Both give the same bits.

The plain versions keep the op order of the JAX fallbacks, rounding
after every operation (PyTorch never contracts separate ops into an
FMA) and storing bf16 with ``.to(torch.bfloat16)`` (round to nearest
even, as the kernels' ``__float2bfloat16_rn``), so on the card every
form of every kernel is bit-identical to its plain version.
"""

import operator

import torch
import torch.nn.functional as F

from canvas_tpu_torch.ops import _build

__all__ = ['solid_fold', 'solid_stack', 'region_over', 'region_over_sep',
           'solid_fold_plain', 'region_over_plain', 'region_over_sep_plain',
           'fold_tile_pixel_layers']

# The damage-region block grid (planner quantization, sources.py).
_QR, _QC = 64, 128
_THREADS = 256
#: The tile of one block of ``solid_fold`` (csrc/fold_tile.cuh).
FOLD_TILE = (16, 128)
#: The stored types of the (P, A) accumulators: f32, or bf16 for the
#: quality <= 9 tier.
_ACC_DTYPES = (torch.float32, torch.bfloat16)


def _blocks(n, per_thread):
    """Blocks along grid.x for *n* items at ~*per_thread* items a thread
    (the kernels loop over the rest with a grid stride)."""
    return max(1, min(-(-n // (_THREADS * per_thread)), 2 ** 31 - 1))


def _need(t, name, dtype, shape, device):
    """The kernels take contiguous tensors of one dtype and shape, on the
    device of the call; anything else raises."""
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            '%s: expected a contiguous %s tensor of shape %s on %s, got %s '
            '%s on %s (contiguous=%s)'
            % (name, dtype, tuple(shape), device, t.dtype, tuple(t.shape),
               t.device, t.is_contiguous()))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _acc_dtype(name, t):
    """The accumulator dtype of *t*, which must be f32 or bf16."""
    if t.dtype not in _ACC_DTYPES:
        raise ValueError('%s: accumulators are f32 or bf16, not %s'
                         % (name, t.dtype))
    return t.dtype


def _count(fn, bf16, vector=None):
    """Add one launch to *fn*'s counter of the f32 or the bf16 form and,
    where the kernel has a 16-byte and a scalar instantiation, to the
    counter of the one launched (*vector* True or False)."""
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1
    if vector:
        fn.launches_vector += 1
    elif vector is not None:
        fn.launches_scalar += 1


def _vector_ok(W, *pointers):
    """Whether a kernel may move 8 neighbouring values of a row with
    16-byte accesses: rows of *W* values with W % 8 == 0, and every plane
    pointer (``data_ptr()``, an int) a multiple of 16. A contiguous view
    can start anywhere in its storage, so the pointers decide, not the
    shapes. Otherwise the scalar instantiation of the same kernel runs."""
    return W % 8 == 0 and all(p % 16 == 0 for p in pointers)


# --- solid_fold ---------------------------------------------------------

def _fold_torch(P, A, color, box, gain, offset, H, W):
    """Premultiplied fold of L solid layers over base (P, A), in the op
    order of ``pallas_ops._fold_jnp`` (pallas_ops.py:66-104): per-layer
    scalar ``(c*g+o)*a`` broadcast into ``where`` selects. Returns the
    per-channel accumulators ``([P0, P1, P2], A)``, each (B, H, W) f32
    (or (1, H, W) for an empty base and no layers)."""
    dev = color.device
    L = color.shape[0]
    rows = torch.arange(H, dtype=torch.int32, device=dev).view(1, H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, W)
    if P is None:
        zero = torch.zeros((1, H, W), dtype=torch.float32, device=dev)
        Pc = [zero, zero, zero]
        Ac = zero
    else:
        Pc = [P[:, c].float() for c in range(3)]
        Ac = A[:, 0].float()
    for l in range(L):
        b = box[l]                                       # (B, 4) i32
        m = ((rows >= b[:, 0, None, None]) &
             (rows <= b[:, 1, None, None]) &
             (cols >= b[:, 2, None, None]) &
             (cols <= b[:, 3, None, None]))              # (B, H, W)
        a = torch.where(m, color[l][:, 3, None, None], 0.0)
        keep = 1.0 - a
        for c in range(3):
            pa = (color[l][:, c] * gain[l] + offset[l]) * color[l][:, 3]
            Pc[c] = torch.where(m, pa[:, None, None], 0.0) + Pc[c] * keep
        Ac = a + Ac * keep
    return Pc, Ac


def solid_fold_plain(P, A, color, box, gain, offset, H, W, finalize=False,
                     out_dtype=None, acc_dtype=None):
    """Plain PyTorch ``solid_fold`` on any device: the JAX fallback
    branch of ``pallas_ops.solid_fold`` (pallas_ops.py:210-225)."""
    Pc, Ac = _fold_torch(P, A, color, box, gain, offset, H, W)
    return _finish(Pc, Ac, color.shape[1], H, W, finalize, out_dtype,
                   acc_dtype)


def _finish(Pc, Ac, B, H, W, finalize, out_dtype=None, acc_dtype=None):
    """The end of a plain fold: the per-channel accumulators ``[P0, P1,
    P2], A`` (each (B, H, W), or (1, H, W) when no layer touched an empty
    base) as ``(P (B, 3, H, W), A (B, 1, H, W))`` stored in *acc_dtype*
    (f32 by default), or with *finalize* the un-premultiplied
    (B, 4, H, W) rgba in *out_dtype* (f32 by default)."""
    if not finalize:
        Ps = torch.stack(Pc, dim=1)
        As = Ac[:, None]
        if acc_dtype is not None:
            Ps, As = Ps.to(acc_dtype), As.to(acc_dtype)
        if Ps.shape[0] != B:             # degenerate all-empty fold
            Ps = Ps.expand(B, 3, H, W).contiguous()
            As = As.expand(B, 1, H, W).contiguous()
        return Ps, As
    nonzero = Ac != 0.0
    safe = torch.where(nonzero, Ac, 1.0)
    rgb = [torch.where(nonzero, Pc[c] / safe, 0.0) for c in range(3)]
    out = torch.stack(rgb + [Ac], dim=1)
    if out.shape[0] != B:
        out = out.expand(B, 4, H, W).contiguous()
    return out.to(out_dtype) if out_dtype is not None else out


def solid_fold(P, A, color, box, gain, offset, H, W, finalize=False,
               out_dtype=None, acc_dtype=None):
    """Fold L solid(+gain/offset) layers over the premultiplied base
    (P, A), bottom to top.

    color (L, B, 4) f32, box (L, B, 4) int32, gain/offset (L, B) f32.
    P (B, 3, H, W) / A (B, 1, H, W) f32 or bf16 (one dtype), or both
    None for an empty base. Returns new (P, A) accumulators stored in
    ``acc_dtype`` (f32 by default, or bf16), or with ``finalize=True``
    the un-premultiplied (B, 4, H, W) rgba in ``out_dtype`` (f32 by
    default, or f16). The math is f32; the kernel rounds to nearest even
    on a narrow store, as ``.half()`` and ``.to(torch.bfloat16)`` do.
    A bf16 base or bf16 accumulators make the launch the bf16 form's.

    CUDA kernel ``csrc/solid_fold.cu`` on a CUDA tensor (bit-identical to
    ``solid_fold_plain``), the plain version on a CPU tensor.
    """
    dev = color.device
    if dev.type == 'cpu':
        return solid_fold_plain(P, A, color, box, gain, offset, H, W,
                                finalize=finalize, out_dtype=out_dtype,
                                acc_dtype=acc_dtype)
    if dev.type != 'cuda':
        raise ValueError('solid_fold: unsupported device %s' % (dev,))
    L, B = color.shape[0], color.shape[1]
    _need(color, 'color', torch.float32, (L, B, 4), dev)
    _need(box, 'box', torch.int32, (L, B, 4), dev)
    _need(gain, 'gain', torch.float32, (L, B), dev)
    _need(offset, 'offset', torch.float32, (L, B), dev)
    if (P is None) != (A is None):
        raise ValueError('solid_fold: P and A must both be given or both '
                         'be None')
    base_dtype = None
    if P is not None:
        base_dtype = _acc_dtype('solid_fold', P)
        _need(P, 'P', base_dtype, (B, 3, H, W), dev)
        _need(A, 'A', base_dtype, (B, 1, H, W), dev)
    if L > 1024 or B > 65535:
        raise ValueError('solid_fold: L=%d layers (max 1024), B=%d frames '
                         '(max 65535)' % (L, B))
    if finalize:
        out_dtype = torch.float32 if out_dtype is None else out_dtype
        if out_dtype not in (torch.float32, torch.float16):
            raise ValueError('solid_fold: finalize stores f32 or f16, not %s'
                             % (out_dtype,))
        out0 = torch.empty((B, 4, H, W), dtype=out_dtype, device=dev)
        outA = None
        mode = 1 if out_dtype == torch.float32 else 2
    else:
        acc_dtype = torch.float32 if acc_dtype is None else acc_dtype
        if acc_dtype not in _ACC_DTYPES:
            raise ValueError('solid_fold: accumulators are f32 or bf16, not '
                             '%s' % (acc_dtype,))
        out0 = torch.empty((B, 3, H, W), dtype=acc_dtype, device=dev)
        outA = torch.empty((B, 1, H, W), dtype=acc_dtype, device=dev)
        mode = 0 if acc_dtype == torch.float32 else 3
    base_bf16 = base_dtype == torch.bfloat16
    if B and H and W:
        planes = [t.data_ptr() for t in (P, A, out0, outA) if t is not None]
        vector = _vector_ok(W, *planes)
        lib = _build.library()
        rc = lib.canvas_solid_fold(
            color.data_ptr(), box.data_ptr(), gain.data_ptr(),
            offset.data_ptr(),
            P.data_ptr() if P is not None else None,
            A.data_ptr() if A is not None else None,
            out0.data_ptr(), outA.data_ptr() if outA is not None else None,
            L, B, H, W, mode, int(base_bf16), int(vector), dev.index,
            _stream(dev))
        _build.check(lib, 'solid_fold', rc)
        _count(solid_fold, base_bf16 or mode == 3, vector)
    return out0 if finalize else (out0, outA)


solid_fold.launches = 0
solid_fold.launches_bf16 = 0
solid_fold.launches_vector = 0
solid_fold.launches_scalar = 0


def fold_tile_pixel_layers(box, H, W):
    """What ``solid_fold``'s kernel folds for these boxes, counted on the
    host as its blocks build their covering lists: ``(inside, across)``,
    the pixel-layer pairs (summed over the frames and the ``FOLD_TILE``
    tiles of an (H, W) frame, clipped to it) that take the step without
    a mask because the layer's box contains the tile, and with the mask
    because the box meets the tile without containing it. Layers whose
    box is empty or misses the tile cost nothing. *box* is (L, B, 4)
    int ``[y0, y1, x0, x1]``, a tensor or an array."""
    box = torch.as_tensor(box).to('cpu', torch.int64)
    nonempty = ((box[..., 0] <= box[..., 1])
                & (box[..., 2] <= box[..., 3]))[..., None]

    def axis(n, tile, lo, hi):
        """Along one axis, per layer: the pixels of the tiles the box
        contains, and of those it meets."""
        first = torch.arange(0, n, tile)
        last = torch.clamp(first + tile, max=n) - 1
        size = last - first + 1
        lo, hi = lo[..., None], hi[..., None]
        inside = (lo <= first) & (hi >= last) & nonempty
        meets = (lo <= last) & (hi >= first) & nonempty
        return (inside * size).sum(-1), (meets * size).sum(-1)

    rows_in, rows_meet = axis(H, FOLD_TILE[0], box[..., 0], box[..., 1])
    cols_in, cols_meet = axis(W, FOLD_TILE[1], box[..., 2], box[..., 3])
    inside = int((rows_in * cols_in).sum())
    return inside, int((rows_meet * cols_meet).sum()) - inside


def solid_stack(color, box, gain, offset, H, W):
    """Standalone composite of L solid(+gain) layers -> (B, 4, H, W) f32:
    ``solid_fold`` with an empty base and finalize."""
    return solid_fold(None, None, color, box, gain, offset, H, W,
                      finalize=True)


# --- region composites ---------------------------------------------------

def _check_region(name, h, w):
    """The region must be whole (64, 128) blocks (pallas_ops.py:294-297,
    391-394)."""
    if h % _QR or w % _QC:
        raise ValueError(
            '%s region (%d, %d) must be a multiple of the (64, 128) block '
            'grid' % (name, h, w))


def _check_offsets(name, dy0, dx0, h, w, H, W):
    """Host-int offsets, block-aligned, with the region inside the
    frame's (64, 128)-aligned envelope (the planner's invariant,
    sources.py region quantization). Returns them as ints."""
    dy0 = operator.index(dy0)
    dx0 = operator.index(dx0)
    Hp, Wp = -(-H // _QR) * _QR, -(-W // _QC) * _QC
    if (dy0 < 0 or dx0 < 0 or dy0 % _QR or dx0 % _QC
            or dy0 + h > Hp or dx0 + w > Wp):
        raise ValueError(
            '%s offset (%d, %d) of a (%d, %d) region must be (64, 128)-'
            'aligned and end inside the (%d, %d) envelope of a (%d, %d) '
            'frame' % (name, dy0, dx0, h, w, Hp, Wp, H, W))
    return dy0, dx0


def region_over_plain(P, A, layer, dy0, dx0):
    """Composite a materialised region *layer* (B, 4, h, w) over (P, A)
    at (dy0, dx0), IN PLACE; returns (P, A). The plain form of
    ``pallas_ops.region_over``'s fallback (pallas_ops.py:298-326): pad
    the accumulators to the (64, 128) envelope, slice the region, blend
    in f32, write it back, crop."""
    B, _c, h, w = layer.shape
    _check_region('region_over', h, w)
    H, W = P.shape[2], P.shape[3]
    dy0, dx0 = _check_offsets('region_over', dy0, dx0, h, w, H, W)
    Hp, Wp = -(-H // _QR) * _QR, -(-W // _QC) * _QC
    padded = Hp != H or Wp != W
    Pp = F.pad(P, (0, Wp - W, 0, Hp - H)) if padded else P
    Ap = F.pad(A, (0, Wp - W, 0, Hp - H)) if padded else A
    ys, xs = slice(dy0, dy0 + h), slice(dx0, dx0 + w)
    subP = Pp[:, :, ys, xs].float()
    subA = Ap[:, :, ys, xs].float()
    la = layer[:, 3:4].float()
    nP = (layer[:, :3].float() * la + subP * (1.0 - la)).to(P.dtype)
    nA = (la + subA * (1.0 - la)).to(A.dtype)
    Pp[:, :, ys, xs] = nP
    Ap[:, :, ys, xs] = nA
    if padded:
        P.copy_(Pp[:, :, :H, :W])
        A.copy_(Ap[:, :, :H, :W])
    return P, A


def region_over(P, A, layer, dy0, dx0):
    """Composite a materialised region *layer* (B, 4, h, w) over the
    premultiplied accumulators (P, A) at block-aligned offsets.

    h % 64 == 0 and w % 128 == 0; dy0/dx0 host ints, block-aligned, the
    region inside the frame's (64, 128) envelope (it may overhang the
    bottom and right edges; those pixels are clipped). P (B, 3, H, W) /
    A (B, 1, H, W) are updated IN PLACE, where the TPU kernel aliased
    them to its outputs; returns (P, A). The layer, P and A are all f32,
    or all bf16 (the quality <= 9 form; the blend math stays f32).

    CUDA kernel ``csrc/region_over.cu`` on a CUDA tensor (bit-identical
    to ``region_over_plain``), the plain version on a CPU tensor.
    """
    B, _c, h, w = layer.shape
    _check_region('region_over', h, w)
    dev = P.device
    if dev.type == 'cpu':
        return region_over_plain(P, A, layer, dy0, dx0)
    if dev.type != 'cuda':
        raise ValueError('region_over: unsupported device %s' % (dev,))
    H, W = P.shape[2], P.shape[3]
    dy0, dx0 = _check_offsets('region_over', dy0, dx0, h, w, H, W)
    dtype = _acc_dtype('region_over', P)
    _need(layer, 'layer', dtype, (B, 4, h, w), dev)
    _need(P, 'P', dtype, (B, 3, H, W), dev)
    _need(A, 'A', dtype, (B, 1, H, W), dev)
    if B > 65535:
        raise ValueError('region_over: B=%d frames (max 65535)' % (B,))
    bf16 = dtype == torch.bfloat16
    n_px = max(0, min(h, H - dy0)) * max(0, min(w, W - dx0))
    if B and n_px:
        lib = _build.library()
        rc = lib.canvas_region_over(
            layer.data_ptr(), P.data_ptr(), A.data_ptr(), B, h, w, H, W,
            dy0, dx0, int(bf16), _blocks(n_px, 4), dev.index, _stream(dev))
        _build.check(lib, 'region_over', rc)
        _count(region_over, bf16)
    return P, A


region_over.launches = 0
region_over.launches_bf16 = 0


def region_over_sep_plain(P, A, color, ry, rx, dy0, dx0):
    """Plain ``region_over_sep``: materialise the rank-1 layer in the
    order of pallas_ops.py:396-398, ``(color*ry)*rx``, then
    ``region_over_plain``. Updates (P, A) in place; returns them."""
    _check_region('region_over_sep', ry.shape[1], rx.shape[1])
    layer = (color[:, :, None, None] * ry[:, None, :, None]
             * rx[:, None, None, :])
    return region_over_plain(P, A, layer, dy0, dx0)


def region_over_sep(P, A, color, ry, rx, dy0, dx0):
    """Composite a RANK-1 region layer ``color[c] * ry[y] * rx[x]`` over
    the premultiplied accumulators (P, A) at block-aligned offsets,
    without materialising the (B, 4, h, w) layer.

    color (B, 4) f32; ry (B, h), rx (B, w) f32 with h % 64 == 0 and
    w % 128 == 0; dy0/dx0 host ints, block-aligned, the region inside
    the frame's (64, 128) envelope (it may overhang the bottom and right
    edges; those pixels are clipped). P (B, 3, H, W) / A (B, 1, H, W),
    both f32 or both bf16 (the quality <= 9 form; the math stays f32),
    are updated IN PLACE, where the TPU kernel aliased them to its
    outputs (``input_output_aliases``); returns (P, A).

    CUDA kernel ``csrc/region_over_sep.cu`` on a CUDA tensor, the plain
    version on a CPU tensor; the kernel rebuilds each pixel's layer value
    in the plain version's order, so the two are bit-identical.
    """
    B, h = ry.shape
    w = rx.shape[1]
    _check_region('region_over_sep', h, w)
    dev = P.device
    if dev.type == 'cpu':
        return region_over_sep_plain(P, A, color, ry, rx, dy0, dx0)
    if dev.type != 'cuda':
        raise ValueError('region_over_sep: unsupported device %s' % (dev,))
    H, W = P.shape[2], P.shape[3]
    dy0, dx0 = _check_offsets('region_over_sep', dy0, dx0, h, w, H, W)
    _need(color, 'color', torch.float32, (B, 4), dev)
    _need(ry, 'ry', torch.float32, (B, h), dev)
    _need(rx, 'rx', torch.float32, (B, w), dev)
    dtype = _acc_dtype('region_over_sep', P)
    _need(P, 'P', dtype, (B, 3, H, W), dev)
    _need(A, 'A', dtype, (B, 1, H, W), dev)
    if B > 65535:
        raise ValueError('region_over_sep: B=%d frames (max 65535)' % (B,))
    bf16 = dtype == torch.bfloat16
    if B and H and W:
        vector = _vector_ok(W, rx.data_ptr(), P.data_ptr(), A.data_ptr())
        lib = _build.library()
        rc = lib.canvas_region_over_sep(
            color.data_ptr(), ry.data_ptr(), rx.data_ptr(), P.data_ptr(),
            A.data_ptr(), B, h, w, H, W, dy0, dx0, int(bf16), int(vector),
            dev.index, _stream(dev))
        _build.check(lib, 'region_over_sep', rc)
        _count(region_over_sep, bf16, vector)
    return P, A


region_over_sep.launches = 0
region_over_sep.launches_bf16 = 0
region_over_sep.launches_vector = 0
region_over_sep.launches_scalar = 0
