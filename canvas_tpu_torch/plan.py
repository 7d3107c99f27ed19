"""The planning context and the persistent stage cache: the counterparts
of ``canvas_tpu.render.PlanContext`` and ``StageLRU``
(canvas_tpu/render.py:219-336, 444-702).

Sources plan themselves into ``Node`` trees (``canvas_tpu_torch.ir``)
through ``PlanContext``: ``plan`` calls the source's ``emit`` and
host-stages the source (``stage``) when that returns None. Staging puts
data on the planner's device, or on every distinct device of the plan's
mesh, through ``staging.SlabStager`` (pinned host stacks, one
preallocated device stack per segment and device); the caches,
keys and grow seeding are the JAX package's. The persistent stage cache
(``StageLRU``) is the planner's ``persistent_cache``:
``stage_cache_mb = 0`` disables it.
"""

import threading
import weakref
from collections import OrderedDict

import numpy as np

from canvas_tpu_torch import backend, profiling
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ir import Node, rel_box_array, tile_window, \
    windows_to_array
from canvas_tpu_torch.staging import SlabStager, device_nbytes

__all__ = ['PlanContext', 'StageLRU']


class StageLRU:
    """Persistent device-resident staging cache (planner lifetime).

    The per-segment staging caches dedup pulls *within* one plan, but
    reset every segment, so a looped or scrubbed-over range would
    re-decode and re-copy on every pass (the reference's render-ahead
    ring keeps recent frames resident, widget_gl.c:25,204-230; here
    staged device stacks stay alive across plans). Entries are keyed by
    (kind, source, window/quality, frame-tuple), segment-granular so
    stack shapes stay stable, and evicted LRU by device bytes. A weakref
    guards against id() reuse: an entry only hits while its source
    object is still alive.

    Invalidation: the planner clears the cache on an un-ranged
    ``frames_updated`` signal; ranged signals drop only entries that
    ever served a root segment touching the range
    (``invalidate_range`` — entries record their serving root ranges
    at get/put time via ``PlanContext.root_range``).
    """

    def __init__(self, budget_bytes):
        self._entries = OrderedDict()
        self.budget = int(budget_bytes)
        self.bytes = 0
        # get/put run on the prepare worker while invalidation arrives
        # from UI/model threads via frames_updated — one lock guards
        # _entries and the byte budget.
        self._lock = threading.Lock()
        # Invalidation generation: puts stamped with an older gen are
        # rejected (a prepare that started BEFORE an edit must not
        # insert pre-edit stages AFTER the invalidation ran — the
        # ranged semantics would keep them forever).
        self.gen = 0

    def get(self, key, source, serving=None):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if entry['ref']() is not source:
                # id() reuse after the original source died: stale entry
                self.bytes -= entry['nbytes']
                del self._entries[key]
                return None
            if serving is not None:
                entry['served'].add(tuple(serving))
            self._entries.move_to_end(key)
            return entry['value']

    def put(self, key, source, value, nbytes, serving=None, gen=None):
        nbytes = int(nbytes)
        with self._lock:
            if gen is not None and gen != self.gen:
                return            # invalidated while this plan prepared
            if nbytes > self.budget:
                # an uncacheable entry must not flush the whole cache on
                # its way to being rejected
                old = self._entries.pop(key, None)
                if old is not None:
                    self.bytes -= old['nbytes']
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old['nbytes']
            while self._entries and self.bytes + nbytes > self.budget:
                _k, dropped = self._entries.popitem(last=False)
                self.bytes -= dropped['nbytes']
            self._entries[key] = {'ref': weakref.ref(source),
                                  'value': value, 'nbytes': nbytes,
                                  'served': (set() if serving is None
                                             else {tuple(serving)})}
            self.bytes += nbytes

    def peek_prefix(self, prefix, source):
        """Most-recently-used value whose key starts with *prefix*
        (same kind/source/quality/mesh, any frame tuple) — lets a grown
        frame set seed per-frame host data from an earlier stack
        instead of re-decoding everything. Read-only: no LRU reorder,
        no serving-range registration (the grown entry records its
        own)."""
        plen = len(prefix)
        with self._lock:
            for key in reversed(self._entries):
                if key[:plen] != prefix:
                    continue
                entry = self._entries[key]
                if entry['ref']() is not source:
                    continue
                return entry['value']
        return None

    def clear(self):
        with self._lock:
            self.gen += 1
            self._entries.clear()
            self.bytes = 0

    def invalidate_range(self, lo, hi):
        """Drop entries that ever served a ROOT frame range touching
        [lo, hi] (hi inclusive) — a ranged frames_updated means content
        inside the range may have mutated in place, and staged planes
        are keyed in child-frame space that can't be mapped back from
        root frames. Entries with no recorded serving range drop too
        (conservative)."""
        with self._lock:
            self.gen += 1
            for key in [k for k, e in self._entries.items()
                        if not e['served']
                        or any(s0 <= hi and lo < s1
                               for (s0, s1) in e['served'])]:
                self.bytes -= self._entries[key]['nbytes']
                del self._entries[key]

    def __len__(self):
        return len(self._entries)


class PlanContext:
    """Planning context handed to ``VideoSource.emit``.

    frames: host int64 array of source-frame indices for this segment.
    window: the target full_window (box2i) this node must render into.
    The planner (``canvas_tpu_torch.render.RenderPlanner``) supplies
    ``device`` and ``render_stream`` (the CUDA stream the staged stacks
    are read on, None off CUDA).
    """

    def __init__(self, planner, frames, window, root_range=None,
                 stage_gen=None, sem_windows=None, mesh=None):
        self.planner = planner
        self.frames = frames
        self.window = window
        # The mesh the staged stacks target (``iter_batches(mesh=)``
        # passes it; derived contexts keep it): a part of every staging
        # key, so a stack replicated over a mesh never serves an
        # unsharded plan, nor the other way round.
        self.mesh = mesh
        # Per-frame SEMANTIC pull windows, a (B, 4) [x0, y0, x1, y1]
        # array (or None = every frame pulls at ``window``): the window
        # the EAGER pull chain would hand each frame's get_frame call.
        # Planner layout may render a node at a larger static window
        # (fetch unions, quantized damage regions), but window-SENSITIVE
        # semantics — the scaler's fetch-box tap clipping
        # (video_scale.c:299-307: taps outside the pulled source rect
        # are dropped, NOT renormalized), pulldown's interleave rows —
        # must follow the eager per-frame windows or the batched path
        # diverges from the pull path (round-3 fuzz find, seed 1034).
        self.sem_windows = sem_windows
        # The ROOT segment this plan serves, in root frame space —
        # derived contexts (with_frames remaps to child frames) keep
        # the original, so staged entries can record which root ranges
        # they served (StageLRU.invalidate_range).
        if root_range is None and len(frames):
            root_range = (int(frames[0]), int(frames[-1]) + 1)
        self.root_range = root_range
        # Invalidation generation at plan START: cache inserts stamped
        # with it are rejected if an edit invalidated mid-plan (the
        # ranged semantics would otherwise keep pre-edit data forever).
        if stage_gen is None:
            stage_gen = planner.persistent_cache.gen if planner else 0
        self.stage_gen = stage_gen

    def with_frames(self, frames):
        # Frame remaps (pass-throughs, sequences, pulldown pulls) keep
        # batch positions, so the per-frame semantic windows stay
        # aligned and carry over.
        return PlanContext(self.planner, np.asarray(frames), self.window,
                           root_range=self.root_range,
                           stage_gen=self.stage_gen,
                           sem_windows=self.sem_windows, mesh=self.mesh)

    def with_window(self, window, sem=None):
        """Re-window. ``sem`` controls the semantic pull windows:
        None resets them to follow *window* (a real re-window — the
        eager chain pulls the child at this window), 'keep' preserves
        the CURRENT effective semantics (planner-internal layout moves
        like damage-region replans), or a (B, 4) array sets per-frame
        windows explicitly (the scaler's per-frame fetch boxes)."""
        if isinstance(sem, str) and sem == 'keep':
            sem = self.sem_windows
            if sem is None:
                sem = tile_window(self.window, len(self.frames))
        return PlanContext(self.planner, self.frames, window,
                           root_range=self.root_range,
                           stage_gen=self.stage_gen,
                           sem_windows=sem, mesh=self.mesh)

    def with_sem(self, sem_windows):
        """Same frames/window with explicit per-frame semantic pull
        windows ((B, 4) [x0, y0, x1, y1]; pulldown hands frame b's
        pulls frame a's current windows, Pulldown23RemovalFilter.c:91)."""
        return PlanContext(self.planner, self.frames, self.window,
                           root_range=self.root_range,
                           stage_gen=self.stage_gen,
                           sem_windows=np.asarray(sem_windows),
                           mesh=self.mesh)

    def sem_array(self):
        """(B, 4) [x0, y0, x1, y1] effective semantic windows."""
        if self.sem_windows is not None:
            return np.asarray(self.sem_windows)
        return tile_window(self.window, len(self.frames))

    # --- node constructors used by sources ------------------------------

    def solid(self, colors, windows):
        """colors: (B,4) f32; windows: list of box2i per frame."""
        B = len(self.frames)
        arr = windows_to_array(windows)
        full = self.window
        clipped_arr = np.stack([
            np.maximum(arr[:, 0], full.min.x),
            np.maximum(arr[:, 1], full.min.y),
            np.minimum(arr[:, 2], full.max.x),
            np.minimum(arr[:, 3], full.max.y)], axis=1)
        rel = rel_box_array(clipped_arr, full)
        return Node('solid',
                    static=(self.window.height, self.window.width),
                    params={'color': np.asarray(colors, np.float32),
                            'box': rel.reshape(B, 4)},
                    windows=clipped_arr)

    def plan(self, source):
        """Plan *source*: its ``emit()``, else host-staged."""
        node = source.emit(self)
        if node is None:
            node = self.stage(source)
        return node

    def stager(self, row_specs, n_real):
        """A ``SlabStager`` onto the planner's device, or onto every
        distinct device of the context's mesh (see staging.py)."""
        consumer = (self.planner.render_stream if self.mesh is None
                    else getattr(self.planner, 'render_streams', None))
        return SlabStager(row_specs, n_real, self.planner.device,
                          consumer=consumer, mesh=self.mesh)

    def stage(self, source):
        """Host-pull fallback (canvas_tpu/render.py:551-669): pull every
        UNIQUE (frame, pull-window) once at the per-frame semantic
        windows, ship the (U, 4, H, W) f16 stack to the device once per
        segment, and gather rows per batch (``stage_rows``). The caches,
        keys and grow seeding are the JAX package's."""
        with profiling.Timer('render.stage'):
            cache = getattr(self.planner, '_stage_cache', None)
            if cache is None:
                cache = self.planner._stage_cache = {}
            persist = self.planner.persistent_cache
            lay = (self.window.min.x, self.window.min.y,
                   self.window.max.x, self.window.max.y)
            key = ('framestack', id(source), lay, self.mesh)
            sem = self.sem_array()
            pw = np.stack([np.maximum(sem[:, 0], lay[0]),
                           np.maximum(sem[:, 1], lay[1]),
                           np.minimum(sem[:, 2], lay[2]),
                           np.minimum(sem[:, 3], lay[3])], axis=1)
            needed = [(int(f), tuple(int(v) for v in pw[b]))
                      for b, f in enumerate(self.frames)]
            hints = getattr(self.planner, '_frame_hints', {})
            hinted = set((int(h), lay) for h in hints.get(id(source), ()))
            entry = cache.get(key)
            if entry is None:
                # replay hit: the segment staged on an earlier pass
                entry = persist.get(key + (tuple(sorted(set(needed)
                                                        | hinted)),),
                                    source, serving=self.root_range)
                if entry is not None:
                    cache[key] = entry
            if entry is None or not all(fw in entry['rows']
                                        for fw in needed):
                frames = sorted(set(needed) | hinted |
                                (set(entry['rows']) if entry else set()))
                pkey = key + (tuple(frames),)
                got_p = persist.get(pkey, source, serving=self.root_range)
                if got_p is not None:
                    entry = cache[key] = got_p
                else:
                    entry = cache[key] = self._stage_frames(
                        source, frames, key, entry)
                    persist.put(pkey, source, entry,
                                device_nbytes((entry['stack'],)),
                                serving=self.root_range, gen=self.stage_gen)
            B = len(self.frames)
            rows = np.asarray([entry['rows'][fw] for fw in needed],
                              np.int32)
            win_arr = np.asarray([entry['windows'][fw] for fw in needed],
                                 np.int64).reshape(B, 4)
            return Node('stage_rows',
                        static=(self.window.height, self.window.width),
                        params={'data': entry['stack'], 'rows': rows},
                        windows=win_arr)

    def _stage_frames(self, source, frames, key, entry):
        """Pull *frames* ((frame, window) pairs) into a pinned host stack,
        shipping slabs as they fill; returns the cache entry. *entry* is
        this plan's smaller entry for *key*, or None."""
        cache = self.planner._stage_cache
        # Grow seeding: a retained host stack (this plan's entry, or the
        # newest persistent one for this source and layout) means only
        # the missing frames pull.
        seed = (entry if entry is not None
                else self.planner.persistent_cache.peek_prefix(key, source))
        if seed is not None and 'host' in seed:
            for fw_old, i in seed['rows'].items():
                fkey = ('stagedframe', id(source), fw_old) + key[2:3]
                if fkey not in cache and i < len(seed['host']):
                    cache[fkey] = (seed['host'][i], seed['windows'][fw_old])
        Hn, Wn = self.window.height, self.window.width
        lay = key[2]
        stager = self.stager([((4, Hn, Wn), np.float16)], len(frames))
        (host,) = stager.host
        windows = {}
        for n, fw in enumerate(frames):
            f, w = fw
            fkey = ('stagedframe', id(source), fw) + key[2:3]
            got = cache.get(fkey)
            if got is None:
                got = cache[fkey] = self._pull_staged(source, f, w, lay,
                                                      Hn, Wn)
            host[n] = got[0]
            windows[fw] = got[1]
            stager.note_row(n)
        (stack,) = stager.finish()
        # the host stack is retained so a later grow of this entry
        # pulls only new frames
        return {'stack': stack, 'host': host,
                'rows': {fw: i for i, fw in enumerate(frames)},
                'windows': windows}

    def _pull_staged(self, source, f, w, lay, Hn, Wn):
        """One staged pull: whole layout window when w == lay, else a
        semantic-window pull embedded in a layout-sized canvas. Staging
        pulls on the host, under the ``'numpy'`` mode whatever the
        thread's (``canvas_tpu/render.py:634``): the stack is copied to
        the device once, in one slab."""
        with backend.force_backend('numpy'):
            return self._pull_host(source, f, w, lay, Hn, Wn)

    def _pull_host(self, source, f, w, lay, Hn, Wn):
        if w == lay:
            frame = source.get_frame_f16(f, self.window)
            cw = frame.current_window
            return (np.asarray(frame.data, np.float16),
                    (cw.min.x, cw.min.y, cw.max.x, cw.max.y)
                    if not cw.empty() else (0, 0, -1, -1))
        canvas = np.zeros((4, Hn, Wn), np.float16)
        if w[2] < w[0] or w[3] < w[1]:       # empty semantic window
            return (canvas, (0, 0, -1, -1))
        frame = source.get_frame_f16(f, box2i(w[0], w[1], w[2], w[3]))
        cw = frame.current_window
        if cw.empty():
            return (canvas, (0, 0, -1, -1))
        data = np.asarray(frame.data, np.float16)
        # place the pulled window region into the layout canvas
        y0 = w[1] - lay[1]
        x0 = w[0] - lay[0]
        canvas[:, y0:y0 + data.shape[1], x0:x0 + data.shape[2]] = data
        return (canvas, (cw.min.x, cw.min.y, cw.max.x, cw.max.y))
