"""Coded (pre-reconstruction) images and DV clips: the port's copy of the
DV part of ``canvas_tpu/coded.py``.

* ``coded_image`` (include/framework.h) -> :class:`CodedImage`, a list
  of NumPy u8 planes;
* ``coded_image_source`` / CodedImageSource.c -> :class:`CodedImageSource`;
* DVReconstructionFilter.c -> :class:`DVReconstructionFilter`: its pull
  path reconstructs with NumPy (``ops.chroma.reconstruct_dv``), its
  ``emit`` plans the batched form. Decode stays on the host
  (``CodedImageSource.get_frame``). Every unique coded frame a segment
  needs is decoded once, its Y/Cb/Cr planes stacked and shipped to the
  device once per segment through the port's ``SlabStager``, and each
  batch gathers its rows on the device (``dv_recon_rows``,
  reconstructed by ``canvas_tpu_torch.render``). The row map, the
  per-frame plane cache, the frame hints and the persistent-cache keys
  are the JAX package's, so the planner's staging caches behave the
  same.

The planar, MPEG-2 and pulldown filters are not ported yet (ROADMAP.md
queue 1 item 6).
"""

import numpy as np

from canvas_tpu_torch.basetypes import EMPTY_BOX2I, box2i, box2i_intersect
from canvas_tpu_torch.frames import VideoSource
from canvas_tpu_torch.ir import Node, tile_window
from canvas_tpu_torch.ops import chroma as chroma_ops
from canvas_tpu_torch.sources import _emit_empty

__all__ = ['CodecPacketSource', 'CodedImage', 'CodedImageSource',
           'DVReconstructionFilter', 'device_plane_stack']


class CodedPlane(np.ndarray):
    """One plane exposed with the reference's per-plane field names
    (coded_image.data/stride/line_count, framework.h) — an ndarray
    subclass, so every array consumer keeps working (``.data`` is the
    inherited buffer view, which PIL's ``Image.frombuffer`` accepts)."""

    @property
    def stride(self):
        return self.strides[0] // self.itemsize

    @property
    def line_count(self):
        return self.shape[0]


class CodedImage:
    """A planar coded image: a list of 2-D uint8 arrays.

    Mirrors the reference's ``coded_image`` (data/stride/line_count per
    plane, framework.h); strides are implicit in the arrays.

    The reference's PER-PLANE constructor is also accepted
    (``process.CodedImage(buffer, stride, line_count)``, as its
    scripts/decode_raw_image.py builds planes): the object then wraps
    ONE plane sharing memory with *buffer* (mutations to the buffer
    show through), with ``.data``/``.stride``/``.line_count``
    attributes, and converts to that plane under ``np.asarray``.
    """

    def __init__(self, planes, stride=None, line_count=None):
        if stride is not None or line_count is not None:
            if stride is None or line_count is None:
                raise TypeError('per-plane form needs BOTH stride and '
                                'line_count')
            self.data = planes                 # the caller's buffer
            arr = np.frombuffer(memoryview(planes), np.uint8)
            arr = arr[:stride * line_count].reshape(line_count, stride)
            self.planes = [arr]
            self.stride = int(stride)
            self.line_count = int(line_count)
            return
        self.planes = [np.asarray(p) for p in planes]

    def __array__(self, dtype=None, copy=None):
        if len(self.planes) != 1:
            raise TypeError('multi-plane CodedImage is not one array')
        a = self.planes[0]
        return a.astype(dtype) if dtype is not None else a

    def __len__(self):
        return len(self.planes)

    def __getitem__(self, i):
        return self.planes[i].view(CodedPlane)

    @property
    def strides(self):
        # the real row stride, not shape-derived: planes can be views
        # sliced from linesize-padded decode buffers
        return [p.strides[0] for p in self.planes]

    @property
    def line_counts(self):
        return [p.shape[0] for p in self.planes]


class CodecPacketSource:
    """Abstract packet-stream face (src/process/CodecPacketSource.c:164):
    ``get_next_packet()``, ``seek(frame)``, ``get_header()``. Python
    implementations just subclass (the reference's BASETYPE flag);
    libav.AVDemuxer and the encoder packet sources implement it.
    """

    def get_header(self):
        """Global stream header bytes, or None."""
        return None

    def get_next_packet(self):
        raise NotImplementedError

    def seek(self, frame):
        raise NotImplementedError


class CodedImageSource:
    """Pull protocol for coded images (src/process/CodedImageSource.c).

    Subclasses implement ``get_frame(frame_index, quality=0)`` returning a
    :class:`CodedImage` or None. Python-implemented sources (the
    reference's get_frame_from_python path, CodedImageSource.c:118+) just
    subclass this directly.
    """

    def get_frame(self, frame_index, quality=0):
        raise NotImplementedError


class DVReconstructionFilter(VideoSource):
    """Coded DV 4:1:1 planar -> linear RGBA video source
    (src/process/DVReconstructionFilter.c:54-96 + video_reconstruct_dv,
    src/cprocess/video_reconstruct.c:50-137)."""

    def __init__(self, source, quality=0):
        if not isinstance(source, CodedImageSource):
            raise TypeError('source must be a CodedImageSource')
        self.source = source
        #: Quality hint forwarded to the coded source's get_frame
        #: (framework.h:510-513: 1 fastest .. 10 normal best, 0 = 10).
        self.quality = int(quality)

    def _render_f16(self, frame_index, frame):
        image = (self.source.get_frame(frame_index, self.quality)
                 if self.source else None)
        if image is None:
            frame.current_window = EMPTY_BOX2I
            return
        frame.data, frame.current_window = chroma_ops.reconstruct_dv(
            (image[0], image[1], image[2]), frame.full_window)

    def emit(self, ctx):
        """The batched node: the planes staged on the device, the
        reconstruction evaluated there (``dv_recon_rows``), placed into
        the plan window. None when a pull fails (the planner then
        host-stages the filter)."""
        ox, oy = chroma_ops.DV_PIC_OFFSET
        image_box = box2i(ox, oy, chroma_ops.DV_FULL_WIDTH + ox - 1,
                          chroma_ops.DV_FULL_HEIGHT + oy - 1)
        current = box2i_intersect(image_box, ctx.window)
        B = len(ctx.frames)
        if current.empty() or self.source is None:
            return _emit_empty(ctx)
        cache = getattr(ctx.planner, '_stage_cache', None)
        if cache is None:
            cache = ctx.planner._stage_cache = {}
        staged = device_plane_stack(ctx, self.source,
                                    _effective_quality(ctx, self.quality),
                                    cache, hint_ids=(id(self),))
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


def _effective_quality(ctx, quality):
    """Planner-level quality (RenderPlanner.quality) caps the coded
    pull quality for degraded preview renders: the LOWER hint wins
    (0 means default-best = 10, framework.h:510-513)."""
    q = 10 if int(quality) == 0 else int(quality)
    pq = int(getattr(ctx.planner, 'quality', 10))
    if pq == 0:
        pq = 10            # 0 = default-best on BOTH sides of the min
    return min(q, pq)


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


def _emit_placed(ctx, recon, image_box, current, B):
    """Crop *recon* (rendered at image_box geometry) to *current* and
    place it into the plan window — shared by the DV and generic planar
    emitters so the offset math cannot drift between them."""
    sy0 = current.min.y - image_box.min.y
    sy1 = current.max.y - image_box.min.y
    sx0 = current.min.x - image_box.min.x
    sx1 = current.max.x - image_box.min.x
    dy0 = current.min.y - ctx.window.min.y
    dx0 = current.min.x - ctx.window.min.x
    return Node('place',
                static=(ctx.window.height, ctx.window.width,
                        sy0, sy1, sx0, sx1, dy0, dx0),
                children=[recon], windows=tile_window(current, B))
