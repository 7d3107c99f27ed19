"""The one traffic generator: drives ``RenderPlanner.iter_batches`` as a
traffic mix (``traffic/<name>.json``) says. Every mix renders one range
from frame 0, start to end, over and over: each pass is one
``iter_batches`` call, as each export or each loop of a range is.

- ``batch``, ``post``, ``max_inflight``: the ``iter_batches`` arguments
  (``max_inflight`` null for unbounded);
- ``fetch``: each batch copied to pinned host memory with
  ``backend.to_host``, as ``libav.write_video``'s producer does;
- ``frames``: the range's length; null for the configuration's whole
  ``length``;
- ``stage_cache_mb``: the planner's staging budget; 0 turns the staging
  and plan caches off, so every pass plans and stages afresh (an
  export); null keeps the port's default (a looped range).

On a cell of more than one device every ``iter_batches`` call takes
``mesh=``, a ``Mesh`` of the cell's devices over the one axis 'frames'
(``iter_batches``'s default ``axis``), each batch's frames split over
them; on one device it takes no ``mesh=``.
"""

import contextlib
import time

from torch.profiler import record_function

from canvas_tpu_torch import backend
from canvas_tpu_torch.mesh import ShardedFrames

from gpubench import inputs


#: Whole passes run before the window (set-up): the first renders each
#: segment's signature once, the second captures its program (a program
#: is captured at its signature's second batch).
WARM_PASSES = 2

#: Frames of the window kept for the check, one at most a batch.
SAMPLES = 6


def _nullspan(_name):
    return contextlib.nullcontext()


def _frame(out, j):
    """A copy of frame *j* of the batch *out*, on the device it was
    rendered on: the batch is freed, the frame kept for the check."""
    one = out[j:j + 1]
    if isinstance(one, ShardedFrames):
        # the mesh splits a batch by frames: one frame is in one shard
        (one, _block), = one.shards
    return one[0].clone()


class Stream:
    """One run's traffic over a planner: ``warm()`` is set-up,
    ``window(seconds)`` the measured window."""

    def __init__(self, planner, config, traffic, seed, sync, mesh=None):
        self.planner = planner
        self.traffic = traffic
        self.shard = {} if mesh is None else {'mesh': mesh}
        self.stop = int(traffic['frames'] or config['length'])
        if traffic['stage_cache_mb'] is not None:
            planner.stage_cache_mb = traffic['stage_cache_mb']
        self.sync = sync
        self.reservoir = inputs.Reservoir(seed, SAMPLES)
        self._pick = inputs.rng(seed, 3)

    def _pass(self):
        t = self.traffic
        return self.planner.iter_batches(
            0, self.stop, batch=t['batch'], device_out=True, post=t['post'],
            max_inflight=t['max_inflight'], **self.shard)

    def _passes(self):
        """``(first_frame, n_valid, out)`` of every batch, pass after
        pass."""
        while True:
            it = self._pass()
            try:
                yield from it
            finally:
                it.close()

    def warm(self):
        for _ in range(WARM_PASSES):
            for _first, _take, out in self._pass():
                if self.traffic['fetch']:
                    backend.to_host(out)
        self.sync()

    def window(self, seconds, traced=False):
        """Run for *seconds*, then wait for the device. Returns the
        window's counts, the first frame of each batch and its harness
        spans."""
        span = record_function if traced else _nullspan
        fetch = self.traffic['fetch']
        frames = short = 0
        firsts = []
        next_s = fetch_s = 0.0
        clock = time.perf_counter
        batches = self._passes()
        try:
            with span('gpubench.window'):
                t0 = clock()
                while True:
                    a = clock()
                    with span('gpubench.next'):
                        first, take, out = next(batches)
                    b = clock()
                    if fetch:
                        with span('gpubench.fetch'):
                            out = backend.to_host(out)
                        fetch_s += clock() - b
                    next_s += b - a
                    frames += take
                    firsts.append(first)
                    if out.shape[0] != take:
                        short += take
                    slot = self.reservoir.slot()
                    if slot is not None and take:
                        j = int(self._pick.integers(min(take, out.shape[0])))
                        self.reservoir.items[slot] = (
                            first + j, _frame(out, j))
                    if clock() - t0 >= seconds:
                        break
                self.sync()
                t1 = clock()
        finally:
            batches.close()
        return {'t0': t0, 't1': t1, 'seconds': t1 - t0, 'frames': frames,
                'batches': len(firsts), 'firsts': firsts, 'short': short,
                'next_s': next_s, 'fetch_s': fetch_s,
                'samples': [s for s in self.reservoir.items
                            if s is not None]}

    def explain(self):
        """``RenderPlanner.explain`` over one pass, cut into the segments
        ``iter_batches`` renders: it cuts at no fewer frames than the
        batch (``min_span``), which ``explain`` takes from
        ``pipeline_chunk``."""
        batch = self.traffic['batch']
        self.planner.pipeline_chunk = max(self.planner.pipeline_chunk,
                                          batch)
        return self.planner.explain(0, self.stop)
