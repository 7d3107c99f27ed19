"""Background frame prefetcher: the port's counterpart of
``canvas_tpu/pullqueue.py`` (the reference's src/process/VideoPullQueue.c).

A small thread pool pulls frames (host planning + device render) off the
UI thread and marshals results back through a dispatch callable. The
reference marshals onto the GLib main loop (g_timeout_add_full,
VideoPullQueue.c:72-97); here the *dispatch* argument plugs into whatever
loop the app has (Qt's singleShot, asyncio's call_soon_threadsafe); the
default runs callbacks on a single dispatch thread.

The queue renders on one device, resolved once when it is built: CUDA
unless the caller passes ``device='cpu'``, and a missing card raises.
Every planner it builds renders there. It differs from the JAX package's
queue on purpose in how a pull is made:

- a source with ``plan_cuts`` always pulls through a B=1
  ``RenderPlanner.render``, at any window size (the JAX queue takes the
  planner only at 16,384 pixels or more under its ``'auto'`` backend);
- a planner that fails delivers ``None`` (warning logged), the queue's
  one failure path. It is never answered with an eager pull: the JAX
  queue's NumPy fallback would hide a broken device path and its kernels
  behind frames that look right;
- only a source with no ``plan_cuts`` pulls eagerly, through its
  ``get_frame_f16``.

Like the JAX queue, an item captures the enqueuing thread's backend
mode (``backend.get_backend()``); the worker pulls under that mode, with
the queue's ``device`` as its eager device, and restores its own mode
afterwards (pool threads are reused). So an eager pull enqueued in the
default mode runs the torch arms on the queue's device, and one
enqueued under ``force_backend('numpy')`` arrives as NumPy.
"""

import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

from canvas_tpu_torch import backend
from canvas_tpu_torch.basetypes import EMPTY_BOX2I, box2i
from canvas_tpu_torch.frames import RgbaFrameF16
from canvas_tpu_torch.logging import getLogger

__all__ = ['VideoPullQueue', 'VideoPullQueueItem']


class VideoPullQueueItem:
    """One queued pull (VideoPullQueue.c item); returned by enqueue()."""
    __slots__ = ('source', 'frame_index', 'window', 'callback', 'data',
                 'cancelled', 'backend_mode')

    def __init__(self, source, frame_index, window, callback, data):
        self.source = source
        self.frame_index = frame_index
        self.window = window
        self.callback = callback
        self.data = data
        self.cancelled = False
        # the backend mode is thread-local: capture the enqueuing
        # thread's, so the worker pulls as the caller would have
        self.backend_mode = backend.get_backend()

    def cancel(self):
        """Best-effort cancel (VideoPullQueue.c:48 volatile flag)."""
        self.cancelled = True


class VideoPullQueue:
    """enqueue(source, frame_index, window, callback, data) -> item.

    callback(frame_index, frame, data) runs via *dispatch* once the
    RgbaFrameF16 is ready, with frame None when the pull failed.
    workers=2 mirrors the reference's pool (VideoPullQueue.c:110).
    *device*: where the planners render (None: CUDA, raising without
    it; 'cpu' runs the kernels' plain versions).
    """

    def __init__(self, workers=2, dispatch=None, planner_cache=32,
                 device=None):
        self.device = backend.resolve_device(device)
        backend.ensure_initialized()
        self._workers = workers
        self._planner_cache = max(1, int(planner_cache))
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix='canvas-pull')
        if dispatch is None:
            self._dispatch_queue = queue.Queue()
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name='canvas-pull-dispatch')
            self._dispatch_thread.start()
            dispatch = self._dispatch_queue.put
        else:
            self._dispatch_queue = None
        self._dispatch = dispatch
        # planner cache: OrderedDict LRU + one lock per planner —
        # RenderPlanner.render mutates shared per-call state
        # (_stage_cache/_frame_hints), so two pool workers pulling the
        # same (source, window) must serialize on it (playback.py
        # documents the same constraint for its _render_lock)
        self._planners = OrderedDict()
        self._planners_lock = threading.Lock()
        self._closed = False

    def _dispatch_loop(self):
        while True:
            fn = self._dispatch_queue.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                import traceback
                traceback.print_exc()

    def enqueue(self, source, frame_index, window, callback, data=None):
        if self._closed:
            raise RuntimeError('queue is closed')
        item = VideoPullQueueItem(source, frame_index, window, callback, data)
        self._pool.submit(self._work, item)
        return item

    def _work(self, item):
        if item.cancelled:
            return
        try:
            with backend.force_backend(item.backend_mode, self.device):
                frame = self._render(item)
        except Exception:
            # the future is never read: an escaped exception would be
            # silently swallowed and the callback never fire, leaving
            # the UI waiting forever — deliver None instead
            getLogger(__name__).warning('frame pull failed', exc_info=True)
            frame = None
        if item.cancelled:
            return

        def deliver():
            if not item.cancelled:
                item.callback(item.frame_index, frame, item.data)

        self._dispatch(deliver)

    def _planner_for(self, source, window):
        """The (planner, lock) of (source, window), built on first use.
        Evicted planners close under their own lock, after the cache
        lock is released: a pull still rendering on one finishes first,
        so close() never drops staged stacks or plans under it."""
        from canvas_tpu_torch import render
        key = (id(source), window)
        evicted = []
        with self._planners_lock:
            entry = self._planners.get(key)
            if entry is None:
                while len(self._planners) > self._planner_cache:
                    # evict ONE cold planner; wholesale clear dumped
                    # every warm one
                    evicted.append(self._planners.popitem(last=False)[1])
                entry = (render.RenderPlanner(source, window,
                                              device=self.device),
                         threading.Lock())
                self._planners[key] = entry
            else:
                self._planners.move_to_end(key)
        for old_planner, old_lock in evicted:
            with old_lock:
                old_planner.close()
        return entry

    def _render(self, item):
        """One frame via a B=1 planned render when the source supports
        planning (its plan runs the device kernels), through the
        source's eager pull (under the item's mode) otherwise. A planner
        failure raises to ``_work``, which delivers None."""
        source, window = item.source, item.window
        if not hasattr(source, 'plan_cuts'):
            return source.get_frame_f16(item.frame_index, window)
        planner, plock = self._planner_for(source, window)
        with plock:
            data, wins = planner.render(item.frame_index,
                                        item.frame_index + 1,
                                        with_windows=True)
        frame = RgbaFrameF16(window)
        x0, y0, x1, y1 = (int(v) for v in wins[0])
        if x1 < x0 or y1 < y0:
            frame.current_window = EMPTY_BOX2I
        else:
            frame.data = data[0]
            frame.current_window = box2i(x0, y0, x1, y1)
        return frame

    def join(self, timeout=None):
        """Drain workers (test helper; the C version has no join)."""
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=self._workers,
                                        thread_name_prefix='canvas-pull')
        if self._dispatch_queue is not None:
            done = threading.Event()
            self._dispatch_queue.put(done.set)
            done.wait(timeout)

    def close(self):
        """Refuse new pulls and close every planner, each under its own
        lock (a pull in flight finishes first; queued ones are
        dropped)."""
        self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._planners_lock:
            entries = list(self._planners.values())
            self._planners.clear()
        for planner, plock in entries:
            with plock:
                planner.close()
        if self._dispatch_queue is not None:
            self._dispatch_queue.put(None)
