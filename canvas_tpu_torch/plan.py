"""The port's planning context: ``canvas_tpu.render.PlanContext`` with its
device staging done by ``canvas_tpu_torch`` instead of JAX.

Sources plan themselves with NumPy through ``canvas_tpu``'s emitters;
only the places where planning puts data on the device differ:

- ``plan`` first looks up the port's own emitter for the source's class
  (``coded.EMITTERS``: the DV reconstruction), then the source's
  ``emit``, and host-stages the source (``stage``) when that returns
  None;
- ``stage`` is ``canvas_tpu/render.py:551-669`` on the port's
  ``SlabStager`` (pinned host stacks, one preallocated device stack per
  segment);
- ``with_frames``, ``with_window`` and ``with_sem`` return this class:
  the JAX package builds derived contexts by class name, and every
  nested plan made through a base context would stage through JAX.

The persistent stage cache (``canvas_tpu.render.StageLRU``, pure Python)
is the planner's inherited ``persistent_cache``: ``stage_cache_mb = 0``
disables it as in the JAX package.
"""

import numpy as np

from canvas_tpu import backend as _host_backend
from canvas_tpu import profiling
from canvas_tpu import render as _ref
from canvas_tpu.render import Node
from canvas_tpu_torch.coded import EMITTERS
from canvas_tpu_torch.staging import SlabStager

__all__ = ['PlanContext']


class PlanContext(_ref.PlanContext):
    """Planning context of ``canvas_tpu_torch.render.RenderPlanner``: the
    planner supplies ``device`` and ``render_stream`` (the CUDA stream
    the staged stacks are read on, None off CUDA)."""

    def _same_class(self, ctx):
        # The base methods construct ``canvas_tpu.render.PlanContext``
        # by name; the derived context keeps every field they set and
        # takes this class.
        ctx.__class__ = type(self)
        return ctx

    def with_frames(self, frames):
        return self._same_class(super().with_frames(frames))

    def with_window(self, window, sem=None):
        return self._same_class(super().with_window(window, sem=sem))

    def with_sem(self, sem_windows):
        return self._same_class(super().with_sem(sem_windows))

    def plan(self, source):
        """Plan *source*: the port's emitter for its class, else its
        ``emit()``, else host-staged."""
        emit = next((EMITTERS[c] for c in type(source).__mro__
                     if c in EMITTERS), None)
        node = emit(source, self) if emit is not None else source.emit(self)
        if node is None:
            node = self.stage(source)
        return node

    def stager(self, row_specs, n_real):
        """A ``SlabStager`` onto the planner's device (see staging.py)."""
        return SlabStager(row_specs, n_real, self.planner.device,
                          consumer=self.planner.render_stream,
                          mesh=self.mesh)

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
                    persist.put(pkey, source, entry, entry['host'].nbytes,
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
        with _host_backend.force_backend('numpy'):
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
