"""Hand-written CUDA kernels of the fold studies and the roofline probe,
each beside its plain PyTorch version: the counterparts of the Pallas
kernels in ``scripts/fold_interior_study.py`` (``fold_variant``),
``scripts/fold_tile_study.py`` (``tile_fold``) and
``scripts/vpu_roofline.py`` (``fma_chain``, ``roofline_fold``).

These are studies: the render path keeps ``cuda_ops.solid_fold``.
Dispatch is as in ``cuda_ops``: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (``csrc/fold_study.cu``,
``csrc/tile_fold.cu``, ``csrc/fma_chain.cu``) or raises, and each kernel
wrapper counts its launches in ``<wrapper>.launches``.

The fold kernels work on 2-D tiles of ``TILE`` pixels, one per block of
256 threads (``csrc/fold_tile.cuh``). The ``cond`` and ``switch``
variants and ``tile_fold`` decide per tile, so their plain versions use
the same tile. Every fold kernel is bit-identical to its plain version,
and the plain folds are bit-identical to ``cuda_ops.solid_fold_plain``
(skipped work multiplies by exactly 1 and adds exactly 0). The FMA chain
rounds once per step on the card and twice (multiply, then add) in its
plain version; ``fma_chain_tol`` bounds the difference.
"""

import torch

from canvas_tpu_torch.ops import _build
from canvas_tpu_torch.ops.cuda_ops import _blocks, _finish, _need, _stream

__all__ = ['VARIANTS', 'TILE', 'fold_variant', 'fold_variant_plain',
           'tile_fold', 'tile_fold_plain', 'fma_chain', 'fma_chain_plain',
           'fma_chain_tol', 'roofline_fold', 'roofline_fold_plain']

#: The forms of fold_interior_study.py's `make_kernel` (42-151).
VARIANTS = ('current', 'rank1', 'cond', 'switch')
#: (rows, columns) of the fold kernels' tile: kTileH x kTileW of
#: csrc/fold_tile.cuh (chosen by measurement on the card, PERF.md).
TILE = (16, 128)
#: Most FMA steps a chain takes (its constants sit in shared memory).
MAX_CHAIN = 8192


def _device(name, t):
    """'cpu' or 'cuda'; any other device raises."""
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError('%s: unsupported device %s' % (name, t.device))
    return t.device.type


def _check_fold(name, color, box, gain, offset, H, W, dev):
    L, B = color.shape[0], color.shape[1]
    _need(color, 'color', torch.float32, (L, B, 4), dev)
    _need(box, 'box', torch.int32, (L, B, 4), dev)
    _need(gain, 'gain', torch.float32, (L, B), dev)
    _need(offset, 'offset', torch.float32, (L, B), dev)
    if L > 1024 or B > 65535 or -(-H // TILE[0]) > 65535:
        raise ValueError('%s: L=%d layers (max 1024), B=%d frames (max '
                         '65535), H=%d rows (max %d)'
                         % (name, L, B, H, 65535 * TILE[0]))
    return L, B


def _tile_tests(b, H, W):
    """Per-pixel views of two per-tile answers for a layer whose (B, 4)
    boxes are *b*: the tile (clipped to the frame) lies inside the box,
    and the box meets the tile. Each (B, H, W) bool."""
    th, tw = TILE
    dev = b.device
    ty0 = torch.arange(0, H, th, dtype=torch.int32, device=dev)
    tx0 = torch.arange(0, W, tw, dtype=torch.int32, device=dev)
    ty1 = torch.clamp(ty0 + th, max=H) - 1
    tx1 = torch.clamp(tx0 + tw, max=W) - 1
    y0, y1, x0, x1 = (b[:, i, None, None] for i in range(4))
    ty0, ty1 = ty0[None, :, None], ty1[None, :, None]
    tx0, tx1 = tx0[None, None, :], tx1[None, None, :]
    inside = (y0 <= ty0) & (y1 >= ty1) & (x0 <= tx0) & (x1 >= tx1)
    meets = (y0 <= ty1) & (y1 >= ty0) & (x0 <= tx1) & (x1 >= tx0)

    def px(t):
        return (t.repeat_interleave(th, 1)[:, :H]
                .repeat_interleave(tw, 2)[:, :, :W])

    return px(inside), px(meets)


# --- fold_interior: four forms of the finalized fold ---------------------

def fold_variant_plain(variant, color, box, gain, offset, H, W):
    """Plain ``fold_variant``: the fold of fold_interior_study.py
    `make_kernel` (42-151) in the form *variant*, per pixel in the op
    order of that form (pallas_ops.py:143-157 for the select masks,
    92-103 of the study for rank-1 masks). ``cond`` and ``switch`` decide
    per tile (``TILE``), as the kernel does: a tile inside a layer's box takes the
    unmasked step, and under ``switch`` a tile the box misses keeps its
    accumulators. Returns (B, 4, H, W) f32."""
    if variant not in VARIANTS:
        raise ValueError('variant %r is not one of %r' % (variant, VARIANTS))
    dev = color.device
    L, B = color.shape[0], color.shape[1]
    rows = torch.arange(H, dtype=torch.int32, device=dev).view(1, H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, W)
    zero = torch.zeros((1, H, W), dtype=torch.float32, device=dev)
    Pc, Ac = [zero, zero, zero], zero
    for l in range(L):
        b = box[l]
        a_s = color[l][:, 3, None, None]
        pa = [((color[l][:, c] * gain[l] + offset[l])
               * color[l][:, 3])[:, None, None] for c in range(3)]
        rm = (rows >= b[:, 0, None, None]) & (rows <= b[:, 1, None, None])
        cm = (cols >= b[:, 2, None, None]) & (cols <= b[:, 3, None, None])
        if variant == 'rank1':
            rf, cf = rm.float(), cm.float()
            a = (a_s * rf) * cf
            keep = 1.0 - a
            Pc = [(pa[c] * rf) * cf + Pc[c] * keep for c in range(3)]
            Ac = a + Ac * keep
            continue
        m = rm & cm
        a = torch.where(m, a_s, 0.0)
        keep = 1.0 - a
        nP = [torch.where(m, pa[c], 0.0) + Pc[c] * keep for c in range(3)]
        nA = a + Ac * keep
        if variant != 'current':
            inside, meets = _tile_tests(b, H, W)
            keep_in = 1.0 - a_s
            nP = [torch.where(inside, pa[c] + Pc[c] * keep_in, nP[c])
                  for c in range(3)]
            nA = torch.where(inside, a_s + Ac * keep_in, nA)
            if variant == 'switch':
                nP = [torch.where(meets, nP[c], Pc[c]) for c in range(3)]
                nA = torch.where(meets, nA, Ac)
        Pc, Ac = nP, nA
    return _finish(Pc, Ac, B, H, W, finalize=True)


def fold_variant(variant, color, box, gain, offset, H, W):
    """Fold L solid(+gain/offset) layers over an empty base and finalize
    to (B, 4, H, W) f32, in one of the forms of fold_interior_study.py:
    ``current`` (select masks), ``rank1`` (float row x column masks),
    ``cond`` (a tile inside the box skips the masks) or ``switch`` (also
    skips a layer that misses the tile). All four give the same bits.

    color (L, B, 4) f32, box (L, B, 4) int32, gain/offset (L, B) f32.
    CUDA kernel ``csrc/fold_study.cu`` on a CUDA tensor (bit-identical to
    ``fold_variant_plain``), the plain version on a CPU tensor.
    """
    if variant not in VARIANTS:
        raise ValueError('variant %r is not one of %r' % (variant, VARIANTS))
    if _device('fold_variant', color) == 'cpu':
        return fold_variant_plain(variant, color, box, gain, offset, H, W)
    dev = color.device
    L, B = _check_fold('fold_variant', color, box, gain, offset, H, W, dev)
    out = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
    if B and H and W:
        lib = _build.library()
        rc = lib.canvas_fold_interior(
            color.data_ptr(), box.data_ptr(), gain.data_ptr(),
            offset.data_ptr(), out.data_ptr(), L, B, H, W,
            VARIANTS.index(variant), dev.index, _stream(dev))
        _build.check(lib, 'fold_variant', rc)
        fold_variant.launches += 1
    return out


fold_variant.launches = 0


# --- tile_fold: per-tile covering layers ---------------------------------

def tile_fold_plain(P, A, color, box, gain, offset, H, W, finalize=False):
    """Plain ``tile_fold``: ``cuda_ops._fold_torch``'s select-mask fold
    (the op order of fold_tile_study.py:96-108) where a tile whose
    (frame-clipped) bounds the layer's box misses keeps its
    accumulators."""
    dev = color.device
    L, B = color.shape[0], color.shape[1]
    rows = torch.arange(H, dtype=torch.int32, device=dev).view(1, H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, W)
    if P is None:
        zero = torch.zeros((1, H, W), dtype=torch.float32, device=dev)
        Pc, Ac = [zero, zero, zero], zero
    else:
        Pc, Ac = [P[:, c] for c in range(3)], A[:, 0]
    for l in range(L):
        b = box[l]
        m = ((rows >= b[:, 0, None, None]) & (rows <= b[:, 1, None, None]) &
             (cols >= b[:, 2, None, None]) & (cols <= b[:, 3, None, None]))
        a = torch.where(m, color[l][:, 3, None, None], 0.0)
        keep = 1.0 - a
        _inside, meets = _tile_tests(b, H, W)
        for c in range(3):
            pa = (color[l][:, c] * gain[l] + offset[l]) * color[l][:, 3]
            Pc[c] = torch.where(meets, torch.where(m, pa[:, None, None], 0.0)
                                + Pc[c] * keep, Pc[c])
        Ac = torch.where(meets, a + Ac * keep, Ac)
    return _finish(Pc, Ac, B, H, W, finalize)


def tile_fold(P, A, color, box, gain, offset, H, W, finalize=False):
    """``cuda_ops.solid_fold`` where each tile folds only the layers whose
    box meets it, in z order (fold_tile_study.py `tile_fold`). P
    (B, 3, H, W) / A (B, 1, H, W) f32, or both None for an empty base.
    Returns new (P, A) f32, or with ``finalize=True`` the
    un-premultiplied (B, 4, H, W) f32.

    CUDA kernel ``csrc/tile_fold.cu`` on a CUDA tensor (each block builds
    its own covering list; bit-identical to ``tile_fold_plain``), the
    plain version on a CPU tensor.
    """
    if _device('tile_fold', color) == 'cpu':
        return tile_fold_plain(P, A, color, box, gain, offset, H, W,
                               finalize=finalize)
    dev = color.device
    L, B = _check_fold('tile_fold', color, box, gain, offset, H, W, dev)
    if (P is None) != (A is None):
        raise ValueError('tile_fold: P and A must both be given or both be '
                         'None')
    if P is not None:
        _need(P, 'P', torch.float32, (B, 3, H, W), dev)
        _need(A, 'A', torch.float32, (B, 1, H, W), dev)
    if finalize:
        out0 = torch.empty((B, 4, H, W), dtype=torch.float32, device=dev)
        outA = None
    else:
        out0 = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
        outA = torch.empty((B, 1, H, W), dtype=torch.float32, device=dev)
    if B and H and W:
        lib = _build.library()
        rc = lib.canvas_tile_fold(
            color.data_ptr(), box.data_ptr(), gain.data_ptr(),
            offset.data_ptr(),
            P.data_ptr() if P is not None else None,
            A.data_ptr() if A is not None else None,
            out0.data_ptr(), outA.data_ptr() if outA is not None else None,
            L, B, H, W, int(finalize), dev.index, _stream(dev))
        _build.check(lib, 'tile_fold', rc)
        tile_fold.launches += 1
    return out0 if finalize else (out0, outA)


tile_fold.launches = 0


# --- the roofline probe ---------------------------------------------------

def fma_chain_plain(x, c, k):
    """Plain ``fma_chain``: vpu_roofline.py:93-97, ``acc = x`` then k
    times ``acc = acc * c[i] + x``, each multiply and add rounded to f32."""
    acc = x
    for i in range(k):
        acc = acc * c[i] + x
    return acc.clone() if k == 0 else acc


def fma_chain_tol(x, c, k):
    """A bound on |fma_chain - fma_chain_plain| for f32 *x* and constants
    *c* with |c[i]| <= g < 1 (and on each against the exact chain):
    |acc| <= |x| / (1 - g) at every step; a step rounds at most twice,
    adding at most 2**-24 * (|acc * c| + |acc'|) <= 2 * 2**-24 * max|acc|
    of error; earlier errors shrink by g per step. So each side is within
    2 * 2**-24 * max|x| / (1 - g)**2 of the exact chain to first order,
    the two within twice that, and the bound doubles it once more for
    the higher-order terms."""
    g = float(c[:k].abs().max()) if k else 0.0
    if g >= 1.0:
        raise ValueError('fma_chain_tol needs constants in (-1, 1), got '
                         'max |c| = %r' % g)
    return 8 * 2.0 ** -24 * float(x.abs().max()) / (1.0 - g) ** 2


def fma_chain(x, c, k):
    """k chained fused multiply-adds per element of the f32 tensor *x*
    (the roofline probe's FMA chain, vpu_roofline.py:91-117): ``acc = x``
    then ``acc = fma(acc, c[i], x)`` for i < k. c is a 1-D f32 tensor of
    at least k constants; k <= MAX_CHAIN.

    CUDA kernel ``csrc/fma_chain.cu`` on a CUDA tensor, one rounding per
    step; the plain version on a CPU tensor. The two agree within
    ``fma_chain_tol``.
    """
    k = int(k)
    if not 0 <= k <= MAX_CHAIN or c.dim() != 1 or c.shape[0] < k:
        raise ValueError('fma_chain: k=%d needs 0 <= k <= %d and at least k '
                         'constants, got c of shape %s'
                         % (k, MAX_CHAIN, tuple(c.shape)))
    if _device('fma_chain', x) == 'cpu':
        return fma_chain_plain(x, c, k)
    dev = x.device
    _need(x, 'x', torch.float32, x.shape, dev)
    _need(c, 'c', torch.float32, c.shape, dev)
    if x.data_ptr() % 16:
        raise ValueError('fma_chain: x must be 16-byte aligned')
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        lib = _build.library()
        rc = lib.canvas_fma_chain(x.data_ptr(), c.data_ptr(), out.data_ptr(),
                                  n, k, _blocks(max(1, n // 4), 4),
                                  dev.index, _stream(dev))
        _build.check(lib, 'fma_chain', rc)
        fma_chain.launches += 1
    return out


fma_chain.launches = 0


def roofline_fold_plain(x, col, box, mult):
    """Plain ``roofline_fold``: vpu_roofline.py:152-190, the L layers of
    (L, 4) *col* and *box* (shared by all frames) folded over the image
    base x (B, 4, H, W), in the select form or (*mult*) with
    multiplicative f32 indicators; returns (B, 4, H, W) f32, not
    finalized."""
    H, W = x.shape[2], x.shape[3]
    dev = x.device
    rows = torch.arange(H, dtype=torch.int32, device=dev).view(H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).view(1, W)
    Pc = [x[:, c] for c in range(3)]
    Ac = x[:, 3]
    for l in range(col.shape[0]):
        a_s = col[l, 3]
        rm = (rows >= box[l, 0]) & (rows <= box[l, 1])
        cm = (cols >= box[l, 2]) & (cols <= box[l, 3])
        if mult:
            wt = rm.float() * cm.float()
            av = a_s * wt
            keep = 1.0 - av
            Pc = [(col[l, c] * a_s) * wt + Pc[c] * keep for c in range(3)]
        else:
            m = rm & cm
            av = torch.where(m, a_s, 0.0)
            keep = 1.0 - av
            Pc = [torch.where(m, col[l, c] * a_s, 0.0) + Pc[c] * keep
                  for c in range(3)]
        Ac = av + Ac * keep
    return torch.stack(Pc + [Ac], dim=1)


def roofline_fold(x, col, box, mult):
    """The roofline probe's fold (vpu_roofline.py `fold_kernel`,
    151-191): L layers of (L, 4) f32 *col* and (L, 4) int32 *box*, shared
    by all frames, over the image base x (B, 4, H, W) f32, in the select
    form or (*mult*) with multiplicative indicators. Returns
    (B, 4, H, W) f32, not finalized.

    CUDA kernel ``csrc/fold_study.cu`` on a CUDA tensor (bit-identical to
    ``roofline_fold_plain``), the plain version on a CPU tensor.
    """
    if _device('roofline_fold', x) == 'cpu':
        return roofline_fold_plain(x, col, box, mult)
    dev = x.device
    B, _c, H, W = x.shape
    L = col.shape[0]
    _need(x, 'x', torch.float32, (B, 4, H, W), dev)
    _need(col, 'col', torch.float32, (L, 4), dev)
    _need(box, 'box', torch.int32, (L, 4), dev)
    if L > 1024 or B > 65535 or -(-H // TILE[0]) > 65535:
        raise ValueError('roofline_fold: L=%d layers (max 1024), B=%d frames '
                         '(max 65535), H=%d rows' % (L, B, H))
    out = torch.empty_like(x)
    if B and H and W:
        lib = _build.library()
        rc = lib.canvas_roofline_fold(
            x.data_ptr(), col.data_ptr(), box.data_ptr(), out.data_ptr(), L,
            B, H, W, int(bool(mult)), dev.index, _stream(dev))
        _build.check(lib, 'roofline_fold', rc)
        roofline_fold.launches += 1
    return out


roofline_fold.launches = 0
