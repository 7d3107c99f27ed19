"""Coded DV clips in the batched render: the counterpart of
``canvas_tpu/coded.py``'s ``_device_plane_stack`` and ``_dvrecon_emit``
(coded.py:361-539), staging the planes through the port's
``SlabStager`` instead of JAX.

Decode stays on the host (``CodedImageSource.get_frame``). Every unique
coded frame a segment needs is decoded once, its Y/Cb/Cr planes stacked
and shipped to the device once per segment, and each batch gathers its
rows on the device (``dv_recon_rows``, reconstructed by
``canvas_tpu_torch.render``). The row map, the per-frame plane cache,
the frame hints and the persistent-cache keys are the JAX package's, so
the planner's staging caches behave the same. The NumPy helpers
(``_emit_placed``, ``_effective_quality``, the chroma matrices) are
reused by import.
"""

import numpy as np

from canvas_tpu.basetypes import box2i, box2i_intersect
from canvas_tpu.coded import (DVReconstructionFilter, _effective_quality,
                              _emit_placed)
from canvas_tpu.ops import chroma as chroma_ops
from canvas_tpu.render import Node, tile_window
from canvas_tpu.sources import _emit_empty

__all__ = ['device_plane_stack', 'dvrecon_emit', 'EMITTERS']


def device_plane_stack(ctx, source, quality, cache, hint_ids=()):
    """Segment-level device staging of coded planes.

    Returns ``((py, pcb, pcr), row_of)``: (U, H, W) uint8 device stacks
    covering every frame this segment needs from *source* (plus the
    frames parents declared in the planner's ``_frame_hints``), and
    ``row_of`` mapping frame index -> stack row. Returns None if a coded
    pull fails or the plane shapes change mid-stream (the caller then
    host-stages the whole node)."""
    key = ('dvplanes', id(source), int(quality), ctx.mesh)
    needed = [int(f) for f in ctx.frames]
    entry = cache.get(key)
    if entry is not None and all(f in entry['rows'] for f in needed):
        return entry['stacks'], entry['rows']

    all_hints = getattr(ctx.planner, '_frame_hints', {})
    hinted = set()
    for hid in tuple(hint_ids) + (id(source),):
        hinted.update(int(h) for h in all_hints.get(hid, ()))

    persist = ctx.planner.persistent_cache
    frames = sorted(set(needed) | hinted |
                    (set(entry['rows']) if entry else set()))
    pkey = key + (tuple(frames),)
    # replay hit: a loop over an already-staged segment keeps its device
    # plane stacks (no decode, no copy)
    got_p = persist.get(pkey, source, serving=ctx.root_range)
    if got_p is not None:
        cache[key] = got_p
        return got_p['stacks'], got_p['rows']
    # seed the per-frame cache from retained host stacks, so a grown
    # frame set decodes only the frames the old entry lacks
    seed = entry if entry is not None else persist.peek_prefix(key, source)
    if seed is not None and 'host' in seed:
        hy, hcb, hcr = seed['host']
        for f_old, i in seed['rows'].items():
            if i >= seed.get('n_real', 0):
                continue
            fkey_old = ('dvframe', id(source), int(quality), f_old)
            if fkey_old not in cache:
                cache[fkey_old] = (hy[i], hcb[i], hcr[i])

    stager = None
    for n, f in enumerate(frames):
        fkey = ('dvframe', id(source), int(quality), f)
        planes = cache.get(fkey)
        if planes is None:
            image = source.get_frame(f, quality)
            if image is None:
                return None
            planes = (np.asarray(image[0]), np.asarray(image[1]),
                      np.asarray(image[2]))
            cache[fkey] = planes
        if stager is None:
            stager = ctx.stager([(p.shape, p.dtype) for p in planes],
                                len(frames))
        elif any(p.shape != s.shape[1:]
                 for p, s in zip(planes, stager.host)):
            return None          # plane size changed mid-stream
        for s, p in zip(stager.host, planes):
            s[n] = p
        stager.note_row(n)
    stacks = stager.finish()
    row_of = {f: i for i, f in enumerate(frames)}
    # host stacks retained: growing this entry later decodes only the
    # frames it lacks
    entry = cache[key] = {'stacks': stacks, 'rows': row_of,
                          'host': stager.host, 'n_real': len(frames)}
    persist.put(pkey, source, entry, sum(s.nbytes for s in stager.host),
                serving=ctx.root_range, gen=ctx.stage_gen)
    return stacks, row_of


def dvrecon_emit(filt, ctx):
    """The batched node of a ``DVReconstructionFilter``: its planes
    staged on the device, the reconstruction evaluated there
    (``dv_recon_rows``), placed into the plan window. None when a pull
    fails (the planner then host-stages the filter)."""
    ox, oy = chroma_ops.DV_PIC_OFFSET
    image_box = box2i(ox, oy, chroma_ops.DV_FULL_WIDTH + ox - 1,
                      chroma_ops.DV_FULL_HEIGHT + oy - 1)
    current = box2i_intersect(image_box, ctx.window)
    B = len(ctx.frames)
    if current.empty() or filt.source is None:
        return _emit_empty(ctx)
    cache = getattr(ctx.planner, '_stage_cache', None)
    if cache is None:
        cache = ctx.planner._stage_cache = {}
    staged = device_plane_stack(ctx, filt.source,
                                _effective_quality(ctx, filt.quality),
                                cache, hint_ids=(id(filt),))
    if staged is None:
        return None
    (py, pcb, pcr), row_of = staged
    rows = np.asarray([row_of[int(f)] for f in ctx.frames], np.int32)
    recon = Node('dv_recon_rows', params={
        'py': py, 'pcb': pcb, 'pcr': pcr, 'rows': rows,
        'up': chroma_ops._dv_up_matrix(),
        'm': chroma_ops.YCBCR_TO_RGB_REC709,
    }, windows=tile_window(current, B))
    return _emit_placed(ctx, recon, image_box, current, B)


#: The port's own emitters, by source class: ``PlanContext.plan`` uses
#: these before a source's ``emit`` (which would stage through JAX).
EMITTERS = {DVReconstructionFilter: dvrecon_emit}
