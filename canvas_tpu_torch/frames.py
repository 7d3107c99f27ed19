"""Video frames and the pull-protocol source base class: the port's copy
of ``canvas_tpu/frames.py``.

* ``rgba_frame_f16`` / ``rgba_frame_f32`` (framework.h:155-213) are
  :class:`RgbaFrameF16` / :class:`RgbaFrameF32`: channel-planar
  ``(4, H, W)`` arrays sized to ``full_window``, zero outside
  ``current_window``. ``data`` is a NumPy array or, where the eager pull
  took the torch arm (``canvas_tpu_torch.backend``), a tensor on that
  arm's device; ``to_numpy``, ``pixel``, indexing and
  ``to_argb_string`` read a host copy fetched once per data object.
* ``video_get_frame_f16/f32`` dispatch (src/cprocess/main.c:33-172) is
  :class:`VideoSource`: subclasses implement ``_render_f16`` and/or
  ``_render_f32``; the base class converts between whichever is native.

Frames are also sources (like the reference's RgbaFrameF16.c): pulling from
a frame re-windows its stored image, regardless of frame index.
"""

import contextlib

import numpy as np

from canvas_tpu_torch import backend
from canvas_tpu_torch.basetypes import (EMPTY_BOX2I, box2i, box2i_intersect,
                                        rgba)
from canvas_tpu_torch.ops import window as window_ops

__all__ = ['VideoSource', 'RgbaFrameF16', 'RgbaFrameF32']


class VideoSource:
    """Pull-protocol video source.

    Subclasses override ``_render_f32(frame_index, frame)`` (and/or
    ``_render_f16``) to fill ``frame.data`` and set ``frame.current_window``.
    The frame passed in has its ``full_window`` set and ``data`` zeroed.
    """

    def get_frame_f16(self, frame_index, data_window, **kwargs):
        frame = RgbaFrameF16(data_window)
        self.render_f16(int(frame_index), frame, **kwargs)
        return frame

    def get_frame_f32(self, frame_index, data_window, **kwargs):
        frame = RgbaFrameF32(data_window)
        self.render_f32(int(frame_index), frame, **kwargs)
        return frame

    # -- internal dispatch (cprocess/main.c video_get_frame_f16/f32) -------

    def _has_native(self, name):
        return getattr(type(self), name) is not getattr(VideoSource, name)

    def render_f16(self, frame_index, frame, **kwargs):
        with self._forced_backend(kwargs):
            if self._has_native('_render_f16'):
                self._render_f16(frame_index, frame)
            elif self._has_native('_render_f32'):
                temp = RgbaFrameF32(frame.full_window)
                self._render_f32(frame_index, temp)
                frame.data = window_ops.convert(temp.data, np.float16)
                frame.current_window = temp.current_window
            else:
                frame.current_window = EMPTY_BOX2I

    def render_f32(self, frame_index, frame, **kwargs):
        with self._forced_backend(kwargs):
            if self._has_native('_render_f32'):
                self._render_f32(frame_index, frame)
            elif self._has_native('_render_f16'):
                temp = RgbaFrameF16(frame.full_window)
                self._render_f16(frame_index, temp)
                frame.data = window_ops.convert(temp.data, np.float32)
                frame.current_window = temp.current_window
            else:
                frame.current_window = EMPTY_BOX2I

    @staticmethod
    def _forced_backend(kwargs):
        """The reference's tests pass ``force_gl=`` to take the device
        path; ``force_tpu=`` is the JAX package's spelling. Either one
        pins the torch arm on this thread's eager device, which is
        resolved here: without a card (and no ``device='cpu'`` set by
        ``force_backend``) the pull raises."""
        force = kwargs.pop('force_tpu', None)
        if force is None:
            force = kwargs.pop('force_gl', None)
        else:
            kwargs.pop('force_gl', None)
        if kwargs:
            raise TypeError('unexpected arguments: %r' % sorted(kwargs))
        if force:
            return backend.force_backend('torch', backend.eager_device())
        return contextlib.nullcontext()

    def _render_f16(self, frame_index, frame):
        raise NotImplementedError

    def _render_f32(self, frame_index, frame):
        raise NotImplementedError

    # -- batched render-plan protocol (canvas_tpu_torch.render) ------------

    def plan_cuts(self, start, stop):
        """Frame indices in [start, stop) where this source's graph shape
        changes (sequence/workspace boundaries). Default: none."""
        return []

    def emit(self, ctx):
        """This source's IR node for the frames of *ctx*
        (``canvas_tpu_torch.plan.PlanContext``), or None when it cannot
        be planned (the planner then host-stages its pulled frames)."""
        return None


class _RgbaFrame(VideoSource):
    dtype = None

    def __init__(self, full_window, data=None, current_window=None):
        full_window = box2i(full_window)
        if full_window.empty():
            raise ValueError('full_window must not be empty: %r' % (full_window,))
        self.full_window = full_window
        if data is None:
            data = window_ops.blank(full_window, self.dtype)
            if current_window is None:
                current_window = EMPTY_BOX2I
        else:
            expected = (4, full_window.height, full_window.width)
            if tuple(data.shape) != expected:
                raise ValueError('data shape %r != %r' % (data.shape, expected))
            if current_window is None:
                current_window = full_window
        self.data = data
        self.current_window = box2i(current_window)

    # -- container API ------------------------------------------------------

    @property
    def width(self):
        return self.full_window.width

    @property
    def height(self):
        return self.full_window.height

    def pixel(self, x, y):
        """Color at absolute coordinate (x, y), or None outside
        current_window (RgbaFrameF32.c:95-107)."""
        if not self.current_window.contains_point(x, y):
            return None
        r = y - self.full_window.min.y
        c = x - self.full_window.min.x
        vals = self._host_data()[:, r, c].astype(np.float64)
        return rgba(vals[0], vals[1], vals[2], vals[3])

    def to_numpy(self):
        """Host (4, H, W) array covering full_window."""
        return self._host_data()

    def _host_data(self):
        """Host copy of ``data``: the array itself when it is NumPy, else
        fetched once per data object (``backend.asnumpy``) and kept until
        ``data`` is replaced, so reading pixels one by one costs one
        copy."""
        d = self.data
        if isinstance(d, np.ndarray):
            return d
        cache = getattr(self, '_host_cache', None)
        if cache is None or cache[0] is not d:
            cache = self._host_cache = (d, backend.asnumpy(d))
        return cache[1]

    # -- sequence protocol: raster-order pixel access
    #    (RgbaFrameF32.c:67-92) ------------------------------------------

    def __len__(self):
        return self.width * self.height

    def __getitem__(self, i):
        if i < 0 or i >= len(self):
            raise IndexError('Index was out of range.')
        r, c = divmod(i, self.width)
        vals = self._host_data()[:, r, c].astype(np.float64)
        return rgba(vals[0], vals[1], vals[2], vals[3])

    def to_argb_string(self):
        """8-bit BGRA bytes via the 0.45 gamma ramp (RgbaFrameF16.c:122):
        u8 = clamp(x ** 0.45 * 255)."""
        from canvas_tpu_torch.ops import color as color_ops
        ramped = color_ops.apply_gamma45_u8(self._host_data())
        r, g, b, a = ramped[0], ramped[1], ramped[2], ramped[3]
        # ARGB32 little-endian byte order: B, G, R, A
        return np.stack([b, g, r, a], axis=-1).tobytes()

    # -- source protocol: re-window the stored image ------------------------

    def _render_self(self, frame):
        copy_box = box2i_intersect(self.current_window, frame.full_window)
        src = self.data
        out = window_ops.convert(
            window_ops.place(src, self.full_window, frame.full_window, copy_box),
            frame.dtype)
        frame.data = out
        frame.current_window = copy_box if not copy_box.empty() else EMPTY_BOX2I

    def __repr__(self):
        return '{0}(full_window={1!r}, current_window={2!r})'.format(
            type(self).__name__, self.full_window, self.current_window)


class RgbaFrameF16(_RgbaFrame):
    dtype = np.float16

    def _render_f16(self, frame_index, frame):
        self._render_self(frame)


class RgbaFrameF32(_RgbaFrame):
    dtype = np.float32

    def _render_f32(self, frame_index, frame):
        self._render_self(frame)
