"""Thumbnail painter: async thumbnail strip for a video stream.

Model of the reference's fluggo/editor/ui/canvas/thumbnails.py: requests
frames through a VideoPullQueue (each a B=1 planned render on the
queue's device), caches scaled u8 BGRA thumbnails, and signals when each
is ready. The frames arrive as host arrays; the scale to thumbnail size
and the gamma ramp run on the host (NumPy). The paint layer just blits
the arrays.
"""

import threading

import numpy as np

from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.pullqueue import VideoPullQueue
from canvas_tpu_torch.signal import Signal

__all__ = ['ThumbnailPainter']


class ThumbnailPainter:
    """Maintains *count* thumbnails across [start, start+length) of a
    stream (thumbnails.py:103+). Without a *queue* it builds a
    ``VideoPullQueue(device=device)`` of its own (None: the card)."""

    def __init__(self, stream=None, window=None, size=(80, 60), count=5,
                 queue=None, device=None):
        self.thumbnail_ready = Signal()
        self._stream = stream
        self._window = window or box2i(0, 0, 719, 479)
        self._size = size
        self._count = count
        self._queue = queue or VideoPullQueue(device=device)
        self._lock = threading.Lock()
        self._thumbnails = {}       # slot -> bgra array or None
        self._items = {}            # slot -> queue item (cancellable)
        self._range = (0, 1)

    def set_stream(self, stream):
        self._stream = stream
        self.clear()

    def set_range(self, start, length):
        self._range = (int(start), max(1, int(length)))
        self.clear()

    def clear(self):
        with self._lock:
            # epoch token: cancel() is best-effort (a delivery already
            # past the cancelled check still lands), so stale deliveries
            # from the old stream/range are rejected by generation
            self._epoch = getattr(self, '_epoch', 0) + 1
            for item in self._items.values():
                item.cancel()
            self._items.clear()
            self._thumbnails.clear()

    def frame_for_slot(self, slot):
        start, length = self._range
        if self._count == 1:
            return start
        return start + (length - 1) * slot // (self._count - 1)

    def request_all(self):
        for slot in range(self._count):
            self.request(slot)

    def request(self, slot):
        if self._stream is None:
            return
        with self._lock:
            if slot in self._thumbnails or slot in self._items:
                return
            epoch = getattr(self, '_epoch', 0)
            item = self._queue.enqueue(
                self._stream, self.frame_for_slot(slot), self._window,
                self._deliver, data=(slot, epoch))
            self._items[slot] = item

    def _deliver(self, frame_index, frame, data):
        from canvas_tpu_torch.ops import color as color_ops
        from canvas_tpu_torch.ops import scale as scale_ops

        slot, epoch = data
        if frame is None:
            # failed pull (the queue's documented None delivery):
            # release the slot so a later request can RETRY instead of
            # wedging blank forever
            with self._lock:
                if getattr(self, '_epoch', 0) == epoch:
                    self._items.pop(slot, None)
            return

        # Scale to thumbnail size then gamma-ramp to u8 BGRA
        tw, th = self._size
        factor_x = tw / self._window.width
        factor_y = th / self._window.height
        data, _win = scale_ops.scale_bilinear(
            np.asarray(frame.data, np.float32), frame.full_window,
            frame.current_window if not frame.current_window.empty()
            else frame.full_window,
            box2i(0, 0, tw - 1, th - 1),
            (0.0, 0.0),
            (float(self._window.min.x), float(self._window.min.y)),
            (factor_x, factor_y))
        u8 = color_ops.apply_gamma45_u8(np.asarray(data, np.float16))
        bgra = np.stack([u8[2], u8[1], u8[0], u8[3]], axis=-1)
        with self._lock:
            if getattr(self, '_epoch', 0) != epoch:
                return              # stale delivery from before clear()
            self._thumbnails[slot] = bgra
            self._items.pop(slot, None)
        self.thumbnail_ready(slot, bgra)

    def thumbnail(self, slot):
        with self._lock:
            return self._thumbnails.get(slot)
