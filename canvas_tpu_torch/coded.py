"""Coded (pre-reconstruction) images, the coded-image-source protocol and
the reconstruction, subsample and pulldown filters: the port's copy of
``canvas_tpu/coded.py``.

* ``coded_image`` (include/framework.h) -> :class:`CodedImage`, a list
  of NumPy u8 planes;
* ``coded_image_source`` / CodedImageSource.c -> :class:`CodedImageSource`;
* DVReconstructionFilter.c -> :class:`DVReconstructionFilter`, and its
  generalisation to any integer-factor planar YCbCr geometry,
  :class:`PlanarReconstructionFilter`: the pull path reconstructs through
  ``ops.chroma`` (NumPy, or torch as ``backend.use_torch_for`` chooses),
  ``emit`` plans the batched form. Decode stays
  on the host (``CodedImageSource.get_frame``). Every unique coded frame
  a segment needs is decoded once, its Y/Cb/Cr planes stacked and
  shipped to the device once per segment through the port's
  ``SlabStager``, and each batch gathers its rows on the device
  (``dv_recon_rows`` / ``planar_recon_rows``, reconstructed by
  ``canvas_tpu_torch.render``). The row map, the per-frame plane cache,
  the frame hints and the persistent-cache keys are the JAX package's,
  so the planner's staging caches behave the same;
* DVSubsampleFilter.c / MPEG2SubsampleFilter.c ->
  :class:`DVSubsampleFilter`, :class:`MPEG2SubsampleFilter` (NumPy
  planes out, computed where the pulled frame lies);
* Pulldown23RemovalFilter.c -> :class:`Pulldown23RemovalFilter`: its
  ``emit`` plans solid and mixed cadence frames as one
  ``field_interleave`` of two pulls of its child.
"""

import bisect

import numpy as np
import torch

from canvas_tpu_torch import backend, profiling
from canvas_tpu_torch.basetypes import EMPTY_BOX2I, box2i, box2i_intersect
from canvas_tpu_torch.frames import RgbaFrameF16, VideoSource
from canvas_tpu_torch.ir import Node, tile_window, windows_to_array
from canvas_tpu_torch.ops import chroma as chroma_ops
from canvas_tpu_torch.ops import window as window_ops
from canvas_tpu_torch.sources import _emit_empty
from canvas_tpu_torch.staging import device_nbytes

__all__ = ['CodecPacketSource', 'CodedImage', 'CodedImageSource',
           'DVReconstructionFilter', 'DVSubsampleFilter',
           'MPEG2SubsampleFilter', 'PlanarReconstructionFilter',
           'Pulldown23RemovalFilter', 'device_plane_stack']


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
            (image[0], image[1], image[2]), frame.full_window,
            use_torch=backend.use_torch_for(
                (4, frame.full_window.height, frame.full_window.width)))

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


class PlanarReconstructionFilter(VideoSource):
    """Generic planar YCbCr (4:2:0 / 4:2:2 / 4:1:1 / 4:4:4, 8-bit) ->
    linear RGBA video source: the DV reconstruction generalized to any
    integer-factor geometry (studio expand + separable triangle chroma
    upsample + Rec.709 matrix + scene transfer). This is the preferred
    path for generic decoded video: staging 4:2:0 planes ships ~2.7x
    fewer host->device bytes than staging RGBA.

    *width*/*height* declare the luma geometry for batched planning
    (read from the first frame when omitted)."""

    def __init__(self, source, quality=0, width=None, height=None,
                 matrix='rec709'):
        if not isinstance(source, CodedImageSource):
            raise TypeError('source must be a CodedImageSource')
        if matrix not in ('rec709', 'rec601'):
            raise ValueError("matrix must be 'rec709' or 'rec601'")
        self.source = source
        self.quality = int(quality)
        self.matrix = matrix
        if (width is None) != (height is None):
            raise ValueError('width and height must be given together')
        if width is not None and (int(width) <= 0 or int(height) <= 0):
            raise ValueError('width/height must be positive')
        self._size = ((int(width), int(height))
                      if width is not None else None)

    def _geometry(self):
        if self._size is None:
            # Bounded re-probes: a transient decoder failure (seek
            # hiccup, I/O error) must not downgrade the filter to host
            # staging forever, but re-probing per plan re-seeks+decodes
            # on the prepare thread forever for a stream whose frame 0
            # is genuinely None (pass width/height explicitly for
            # those). Any successful eager decode also heals the
            # geometry permanently (_render_f16 records it).
            fails = getattr(self, '_probe_fails', 0)
            if fails >= 3:
                return None
            image = self.source.get_frame(0, self.quality)
            if image is None:
                self._probe_fails = fails + 1
                return None
            self._size = (image[0].shape[1], image[0].shape[0])
        return self._size

    def _render_f16(self, frame_index, frame):
        image = (self.source.get_frame(frame_index, self.quality)
                 if self.source else None)
        if image is None:
            frame.current_window = EMPTY_BOX2I
            return
        if self._size is None:
            # opportunistic geometry healing: the eager fallback runs
            # exactly when planning couldn't probe, so a successful
            # decode here restores the batched device path
            self._size = (image[0].shape[1], image[0].shape[0])
        frame.data, frame.current_window = chroma_ops.reconstruct_planar(
            (image[0], image[1], image[2]), frame.full_window,
            use_torch=backend.use_torch_for(
                (4, frame.full_window.height, frame.full_window.width)),
            matrix=self.matrix)

    def emit(self, ctx):
        """The batched node for the generic planar reconstruct: the same
        device-resident plane staging as DV (unique frames shipped once
        per segment, rows gathered per batch). None when the geometry is
        unknown, a pull fails or the decoded planes disagree with the
        declared size (the planner then host-stages the filter)."""
        if self.source is None:
            return _emit_empty(ctx)
        geo = self._geometry()
        if geo is None:
            return None          # geometry unknown: host-stage the node
        yw, yh = geo
        image_box = box2i(0, 0, yw - 1, yh - 1)
        current = box2i_intersect(image_box, ctx.window)
        B = len(ctx.frames)
        if current.empty():
            return _emit_empty(ctx)
        cache = getattr(ctx.planner, '_stage_cache', None)
        if cache is None:
            cache = ctx.planner._stage_cache = {}
        staged = device_plane_stack(ctx, self.source,
                                    _effective_quality(ctx, self.quality),
                                    cache, hint_ids=(id(self),),
                                    expect_y=(yh, yw))
        if staged is None:
            return None
        (py, pcb, pcr), row_of = staged
        if (int(py.shape[1]), int(py.shape[2])) != (yh, yw):
            # Decoded plane dims disagree with the declared geometry
            # (coded-size frames / mid-stream dimension change): the eager
            # path reads actual shapes per frame, so fall back to it.
            return None
        rows = np.asarray([row_of[int(f)] for f in ctx.frames], np.int32)
        ch, cw = int(pcb.shape[1]), int(pcb.shape[2])
        recon = Node('planar_recon_rows', params={
            'py': py, 'pcb': pcb, 'pcr': pcr, 'rows': rows,
            'uh': chroma_ops._up_matrix_generic(yw, cw),
            'uv': chroma_ops._up_matrix_generic(
                yh, ch, siting=chroma_ops._vertical_siting(yh, ch)),
            'm': chroma_ops.ycbcr_matrix(self.matrix),
        }, windows=tile_window(current, B))
        return _emit_placed(ctx, recon, image_box, current, B)


class DVSubsampleFilter(CodedImageSource):
    """Video source -> coded DV 4:1:1 planar
    (src/process/DVSubsampleFilter.c:52-66 + video_subsample_dv)."""

    #: The window the filter pulls, offset for the first field
    #: (DVSubsampleFilter.c:55).
    WINDOW = box2i(0, -1, 719, 478)

    def __init__(self, source):
        self.source = source

    def get_frame(self, frame_index, quality=0):
        if self.source is None:
            return None
        frame = self.source.get_frame_f16(frame_index, self.WINDOW)
        y, cb, cr = chroma_ops.subsample_dv(
            frame.data, frame.full_window, frame.current_window)
        return CodedImage([y, cb, cr])


class MPEG2SubsampleFilter(CodedImageSource):
    """Video source -> MPEG-2 4:2:0 interlaced planar
    (src/process/MPEG2SubsampleFilter.c:52-64 + the GL shader pair in
    video_subsample.c:196-293). Pulls the fixed 720x480 window like the
    reference."""

    WINDOW = box2i(0, 0, 719, 479)

    def __init__(self, source):
        self.source = source

    def get_frame(self, frame_index, quality=0):
        if self.source is None:
            return None
        frame = self.source.get_frame_f16(frame_index, self.WINDOW)
        y, cb, cr = chroma_ops.subsample_mpeg2(frame.data, frame.full_window)
        return CodedImage([y, cb, cr])


class Pulldown23RemovalFilter(VideoSource):
    """2:3 pulldown removal (src/process/Pulldown23RemovalFilter.c:47-104).

    Every 5 source (telecined, interlaced) frames carry 4 original film
    frames. *offset* in [0, 4] selects the cadence phase. Three of every
    four output frames map to a solid source frame; the fourth interleaves
    the odd field of one source frame with the even field of the next.
    """

    def __init__(self, source, offset):
        if offset < 0 or offset > 4:
            raise ValueError('offset must be in [0, 4]')
        self.source = source
        self.offset = int(offset)

    def _map(self, frame_index):
        """(solid_source_frame, None) or (mixed_a, mixed_b)."""
        offset = self.offset
        if offset == 4:
            frame_offset = (frame_index + 3) & 3
        else:
            frame_offset = (frame_index + offset) & 3
        base = ((frame_index + offset) >> 2) * 5 - offset
        if frame_offset == 0:
            return base, None
        if frame_offset == 1:
            return base + 1, None
        if frame_offset == 3:
            # Offset 4's cadence is 'DD EE FF FG GH (0->0, 1->1,
            # 2->2), (3->3b4a)': outputs with f % 4 == 0 are the FIRST
            # film frame of the group (source 5g = base - 1 here). The
            # reference C returns base + 4 for them — one full group
            # (5 source frames) late — contradicting its own cadence
            # table; deliberate divergence, like the set_base_filter
            # range-union fix (Pulldown23RemovalFilter.c:64-66,73-79).
            if offset == 4:
                return base - 1, None
            return base + 4, None
        return base + 2, base + 3

    def _render_f16(self, frame_index, frame):
        if self.source is None:
            frame.current_window = EMPTY_BOX2I
            return

        a, b = self._map(frame_index)
        self.source.render_f16(a, frame)
        if b is None or frame.current_window.empty():
            return

        # Keep odd lines (field 2) of frame a; take even lines (field 1)
        # of frame b over the same window (Pulldown23RemovalFilter.c:81-104).
        window = frame.current_window
        temp = RgbaFrameF16(window)
        self.source.render_f16(b, temp)

        temp_placed = window_ops.place(temp.data, temp.full_window,
                                       frame.full_window, window)
        # Rows with even absolute y coordinate starting at
        # (window.min.y + 1) & ~1
        start_y = (window.min.y + 1) & ~1
        if start_y > window.max.y:
            return
        rel = np.arange(frame.full_window.min.y, frame.full_window.max.y + 1)
        even_mask = (rel >= start_y) & (rel <= window.max.y) & (rel % 2 == 0)
        dev = next((t.device for t in (frame.data, temp_placed)
                    if isinstance(t, torch.Tensor)), None)
        if dev is not None:
            mask = backend.as_tensor(even_mask, dev)[None, :, None]
            frame.data = torch.where(mask,
                                     backend.as_tensor(temp_placed, dev),
                                     backend.as_tensor(frame.data, dev))
            return
        data = np.array(frame.data, copy=True)
        data[:, even_mask, :] = np.asarray(temp_placed)[:, even_mask, :]
        frame.data = data

    def get_new_length(self, old_length):
        """Length of the video with pulldown removed
        (Pulldown23RemovalFilter.c:202-234).

        Offset 3's last output of every group mixes the group's final
        source frame with the NEXT group's first ('3->4b5a'), so even
        a complete group of 5 sources can't finish its 4th output:
        count = 4*complete + partial - 1. The reference's
        'partial > 4' branch is unreachable (partial <= 4 always), so
        it over-reports by one and its own last frame pulls past the
        source end — deliberate fix."""
        complete = old_length // 5
        new_length = complete * 4
        partial = old_length % 5
        if self.offset == 3:
            return max(0, new_length + partial - 1)
        thresholds = {0: 2, 1: 1, 2: 0, 4: 3}
        if partial > thresholds[self.offset]:
            partial -= 1
        return new_length + partial

    def plan_cuts(self, start, stop):
        """Map the child's structure cuts through the 4:5 cadence.

        The child reports cuts in ITS frame coordinates; an output frame
        f pulls child frames a(f) (and b(f) for mixed frames), so the
        output must cut wherever the set of child-cut intervals those
        pulls land in changes (forwarding child cuts unmapped would put
        sequence-clip boundaries at the wrong output frames)."""
        if self.source is None or not hasattr(self.source, 'plan_cuts'):
            return []
        start = int(start)
        stop = int(stop)
        if stop <= start:
            return []
        # The child query window must cover EVERY frame the range pulls;
        # derive lo/hi from the actual per-frame pulls, not the endpoints
        # (robust to any cadence shape).
        pulls = []
        for f in range(start, stop):
            a, b = self._map(f)
            pulls.append((a, a if b is None else b))
        lo = min(a for (a, _b) in pulls)
        hi = max(b for (_a, b) in pulls) + 1
        child_cuts = sorted(set(self.source.plan_cuts(lo, hi)))
        if not child_cuts:
            return []

        cuts = []
        prev = None
        for f, (a, b) in zip(range(start, stop), pulls):
            cur = (bisect.bisect_right(child_cuts, a),
                   bisect.bisect_right(child_cuts, b))
            if prev is not None and cur != prev:
                cuts.append(f)
            prev = cur
        return cuts

    def emit(self, ctx):
        """Batched node handling solid and mixed cadence frames in one
        program: every frame interleaves child pulls a and b, where
        solid frames use b == a with an empty row mask (identity). This
        keeps batches intact across the 4-frame cadence
        (Pulldown23RemovalFilter.c:47-104)."""
        if self.source is None:
            return _emit_empty(ctx)

        maps = [self._map(int(f)) for f in ctx.frames]
        frames_a = np.asarray([a for (a, _b) in maps], np.int64)
        frames_b = np.asarray([a if b is None else b for (a, b) in maps],
                              np.int64)
        mixed = np.asarray([b is not None for (_a, b) in maps])

        # Declare the union of both children's frames up front so a coded
        # child stages ONE device plane stack covering both pulls (each
        # unique coded frame crosses host->device once, not twice).
        hints = getattr(ctx.planner, '_frame_hints', None)
        if hints is None:
            hints = ctx.planner._frame_hints = {}
        hints[id(self.source)] = np.unique(np.concatenate(
            [frames_a, frames_b]))

        child_a = ctx.with_frames(frames_a).plan(self.source)
        if not mixed.any():
            return child_a

        # Even absolute rows >= (window.min.y + 1) & ~1, columns clipped
        # to frame a's window (the eager path clips b's temp frame to a's
        # current_window in both axes), come from frame b; solid frames
        # get an empty mask. Window metadata follows frame a (the
        # reference leaves the a-pull's current_window untouched).
        aw = windows_to_array(child_a.windows)
        semw = ctx.sem_windows
        if semw is not None:
            # Nested under a smaller semantic pull: the eager path's
            # a-pull window is clipped by it, and everything below (the
            # interleave rows, b's pull windows) follows the CLIPPED
            # window.
            s = np.asarray(semw)
            aw = np.stack([np.maximum(aw[:, 0], s[:, 0]),
                           np.maximum(aw[:, 1], s[:, 1]),
                           np.minimum(aw[:, 2], s[:, 2]),
                           np.minimum(aw[:, 3], s[:, 3])], axis=1)
        # Frame b's pulls happen INSIDE a temp frame whose full_window is
        # frame a's current_window (Pulldown23RemovalFilter.c:91-96), so
        # b's window-sensitive children (scaler fetch clipping) follow
        # a's per-frame windows, not this node's own pull window.
        child_b = ctx.with_frames(frames_b).with_sem(aw).plan(self.source)
        a_empty = (aw[:, 2] < aw[:, 0]) | (aw[:, 3] < aw[:, 1])
        active = mixed & ~a_empty
        starts = np.where(active, (aw[:, 1] + 1) & ~1, 0).astype(np.int32)
        ends = np.where(active, aw[:, 3], -1).astype(np.int32)
        x0s = np.where(active, aw[:, 0], 0).astype(np.int32)
        x1s = np.where(active, aw[:, 2], -1).astype(np.int32)
        return Node('field_interleave',
                    static=(ctx.window.min.y, ctx.window.min.x),
                    params={'start_y': starts, 'end_y': ends,
                            'x0': x0s, 'x1': x1s},
                    children=[child_a, child_b],
                    windows=aw)


def _effective_quality(ctx, quality):
    """Planner-level quality (RenderPlanner.quality) caps the coded
    pull quality for degraded preview renders: the LOWER hint wins
    (0 means default-best = 10, framework.h:510-513)."""
    q = 10 if int(quality) == 0 else int(quality)
    pq = int(getattr(ctx.planner, 'quality', 10))
    if pq == 0:
        pq = 10            # 0 = default-best on BOTH sides of the min
    return min(q, pq)


def device_plane_stack(ctx, source, quality, cache, hint_ids=(),
                       expect_y=None):
    """Segment-level device staging of coded planes.

    Returns ``((py, pcb, pcr), row_of)``: (U, H, W) uint8 device stacks
    covering every frame this segment needs from *source* (plus the
    frames parents declared in the planner's ``_frame_hints``), and
    ``row_of`` mapping frame index -> stack row. Returns None if a coded
    pull fails, the plane shapes change mid-stream, or the first decoded
    luma plane is not of shape *expect_y* when that is given (the caller
    then host-stages the whole node). A span, ``render.stage.coded``."""
    with profiling.Timer('render.stage.coded'):
        return _device_plane_stack(ctx, source, quality, cache, hint_ids,
                                   expect_y)


def _device_plane_stack(ctx, source, quality, cache, hint_ids, expect_y):
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
            # host staging: a coded source that pulls video (a subsample
            # filter) pulls it on the host, as the planner's frame
            # staging does
            with backend.force_backend('numpy'):
                image = source.get_frame(f, quality)
            if image is None:
                return None
            planes = (np.asarray(image[0]), np.asarray(image[1]),
                      np.asarray(image[2]))
            cache[fkey] = planes
        if stager is None:
            if expect_y is not None \
                    and tuple(planes[0].shape) != tuple(expect_y):
                # the declared geometry disagrees with the stream's decoded
                # size: bail after ONE decode, before decoding and
                # shipping a stack that a check afterwards would discard
                return None
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
    persist.put(pkey, source, entry, device_nbytes(stacks),
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
