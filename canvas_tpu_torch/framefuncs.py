"""Frame functions: animated parameters evaluated per frame index (the
port's copy of ``canvas_tpu/framefuncs.py``, NumPy only).

Capability match for /root/reference/src/process/basicframefuncs.c and
AnimationFunc.c. A frame function maps ``frame -> (v0, v1, v2, v3)`` in
float64; filters interpret the 4-vector as a scalar, point, box, or color.
Constants (numbers, tuples, v2i/v2f/box2i/box2f/rgba) are accepted anywhere
a frame function is (basicframefuncs.c:179-258).

Evaluation happens host-side; the batched render path calls
``get_values_array`` to produce per-frame parameter arrays that are fed to
the compiled device program.
"""


import numpy as np

from canvas_tpu_torch.basetypes import box2i, box2f, rgba, v2i, v2f

__all__ = ['FrameFunction', 'ConstFrameFunc', 'LinearFrameFunc', 'LerpFunc',
           'AnimationFunc', 'AnimationPoint', 'FrameFuncPassThroughFilter',
           'POINT_HOLD', 'POINT_LINEAR', 'as_framefunc',
           'get_box2i', 'get_rgba_f32', 'get_f32', 'get_i32', 'get_v2f']

POINT_HOLD = 0
POINT_LINEAR = 1


class FrameFunction:
    """Base class. Subclasses implement get_values_array."""

    def get_values_array(self, frames):
        """frames: float64 ndarray (N,) -> float64 ndarray (N, 4)."""
        raise NotImplementedError

    def get_values(self, frames):
        """Public API: frames is a number or a sequence; always returns a
        LIST of 4-tuples, matching the reference's
        ``FrameFunction.get_values`` (basicframefuncs.c:422-452; see
        tests/process/frame_func.py usage ``get_values(0)[0]``).
        """
        arr = np.atleast_1d(np.asarray(frames, dtype=np.float64))
        values = self.get_values_array(arr)
        return [tuple(row) for row in values]


class ConstFrameFunc(FrameFunction):
    def __init__(self, values):
        self.values = np.zeros(4, dtype=np.float64)
        vals = list(values)[:4]
        self.values[:len(vals)] = vals

    def get_values_array(self, frames):
        return np.broadcast_to(self.values, (len(frames), 4)).copy()

    def __repr__(self):
        return 'ConstFrameFunc({0})'.format(tuple(self.values))


class LinearFrameFunc(FrameFunction):
    """f(frame) = (frame * a + b, 0, 0, 0) — basicframefuncs.c:86-93."""

    def __init__(self, a, b):
        self.a = float(a)
        self.b = float(b)

    def get_values_array(self, frames):
        out = np.zeros((len(frames), 4), dtype=np.float64)
        out[:, 0] = frames * self.a + self.b
        return out


class LerpFunc(FrameFunction):
    """Linear ramp over *length* frames from *start* to *end* 4-vectors,
    extrapolating outside [0, length] — basicframefuncs.c:159-167."""

    def __init__(self, start, end, length):
        if float(length) <= 0.0:
            raise ValueError('length must be greater than zero.')
        self.start = np.zeros(4, dtype=np.float64)
        self.end = np.zeros(4, dtype=np.float64)
        s, e = list(start)[:4], list(end)[:4]
        self.start[:len(s)] = s
        self.end[:len(e)] = e
        # The reference stores the endpoints as box2f (FLOAT32,
        # basicframefuncs.c:105-167) and lerps those in double; keeping
        # full-precision doubles here diverged by ~1e-8 — enough to
        # flip a get_i32 at a half-integer boundary.
        self.start = self.start.astype(np.float32).astype(np.float64)
        self.end = self.end.astype(np.float32).astype(np.float64)
        self.length = float(length)

    def get_values_array(self, frames):
        f = np.asarray(frames, np.float64)[:, None]
        # reference op order: frame * (e - s) / length + s
        return f * (self.end - self.start) / self.length + self.start


class AnimationPoint:
    """A keyframe: interpolation type, frame position, and 4-vector value.

    Mutable (AnimationFunc.c allows ``point.frame = x`` etc.); the owning
    AnimationFunc re-sorts on access.
    """

    __slots__ = ('_func', 'type', '_frame', '_values')

    def __init__(self, type, frame, values):
        self._func = None
        self.type = type
        self._frame = float(frame)
        vals = np.zeros(4, dtype=np.float64)
        if not hasattr(values, '__len__'):
            values = (float(values),)
        v = list(values)[:4]
        vals[:len(v)] = v
        self._values = vals

    @property
    def frame(self):
        return self._frame

    @frame.setter
    def frame(self, value):
        self._frame = float(value)
        if self._func is not None:
            self._func._dirty = True

    @property
    def values(self):
        return tuple(self._values)

    @values.setter
    def values(self, values):
        vals = np.zeros(4, dtype=np.float64)
        if not hasattr(values, '__len__'):
            values = (float(values),)
        v = list(values)[:4]
        vals[:len(v)] = v
        self._values = vals

    def __repr__(self):
        return 'AnimationPoint(type={0}, frame={1}, values={2})'.format(
            self.type, self._frame, tuple(self._values))


class AnimationFunc(FrameFunction):
    """Keyframe curve with hold/linear segments — AnimationFunc.c:413-463.

    Semantics: before the first point, the first point's value; after the
    last, the last point's value; a HOLD point holds its value until the
    next point; a LINEAR point lerps to the next point. No points -> zeros.
    """

    def __init__(self):
        self._points = []
        self._dirty = False
        # The reference guards the curve with a reader/writer lock
        # (AnimationFunc.c g_rw_lock): planning evaluates on the
        # prepare thread while the editor mutates keyframes on the UI
        # thread. get_values_array snapshots under this lock.
        import threading
        self._lock = threading.Lock()

    def add(self, type_or_point, frame=None, values=None):
        if isinstance(type_or_point, AnimationPoint):
            point = type_or_point
        else:
            point = AnimationPoint(type_or_point, frame, values)
        point._func = self
        with self._lock:
            self._points.append(point)
            self._dirty = True
        return point

    def remove(self, point):
        with self._lock:
            self._points.remove(point)
            self._dirty = True
        point._func = None

    def __len__(self):
        return len(self._points)

    def __getitem__(self, index):
        with self._lock:
            self._ensure_sorted()
            return self._points[index]

    def _ensure_sorted(self):
        if self._dirty or any(
                i and self._points[i - 1]._frame > p._frame
                for i, p in enumerate(self._points)):
            self._points.sort(key=lambda p: p._frame)
            self._dirty = False

    def get_values_array(self, frames):
        frames = np.asarray(frames, np.float64)
        out = np.zeros((len(frames), 4), dtype=np.float64)
        # Snapshot under the lock (concurrent editor mutations), then
        # evaluate VECTORIZED — the per-frame bisect loop ran under the
        # GIL on the prepare thread for every animated param of every
        # batch.
        with self._lock:
            self._ensure_sorted()
            if not self._points:
                return out
            keys = np.asarray([p._frame for p in self._points], np.float64)
            vals = np.asarray([p._values for p in self._points], np.float64)
            types = np.asarray([p.type for p in self._points])
        P = len(keys)

        idx = np.searchsorted(keys, frames, side='right') - 1
        before = idx < 0
        idxc = np.clip(idx, 0, P - 1)
        has_right = idxc + 1 < P
        ridx = np.minimum(idxc + 1, P - 1)
        left_v, right_v = vals[idxc], vals[ridx]
        left_f, right_f = keys[idxc], keys[ridx]
        left_t = types[idxc]

        hold = (~has_right) | (left_t == POINT_HOLD)
        out[hold] = left_v[hold]
        lin = has_right & (left_t == POINT_LINEAR)
        span = right_f - left_f
        zspan = lin & (span == 0)
        out[zspan] = right_v[zspan]
        lin &= span != 0
        t = ((frames - left_f) / np.where(span == 0, 1.0, span))[:, None]
        lerped = left_v * (1.0 - t) + right_v * t
        out[lin] = lerped[lin]
        # unknown types stay zeros (reference behavior)
        out[before] = vals[0]
        return out


class FrameFuncPassThroughFilter(FrameFunction):
    """Re-times another frame function: f(frame) = inner(frame + offset)
    — FrameFuncPassThroughFilter.c:44-46."""

    def __init__(self, source, offset=0.0):
        self.source = as_framefunc(source)
        self.offset = float(offset)

    def get_values_array(self, frames):
        return self.source.get_values_array(
            np.asarray(frames, dtype=np.float64) + self.offset)


def as_framefunc(value):
    """Coerce *value* to a FrameFunction (None -> zeros constant).

    Mirrors py_framefunc_take_source's constant parsing
    (basicframefuncs.c:179-258): box types map to [min.x, min.y, max.x,
    max.y]; 2-vectors to [x, y, 0, 0]; tuples of <=4 floats; bare numbers
    to [v, 0, 0, 0].
    """
    if value is None:
        return ConstFrameFunc((0.0, 0.0, 0.0, 0.0))
    if isinstance(value, FrameFunction):
        return value
    if isinstance(value, (box2i, box2f)):
        return ConstFrameFunc((value.min.x, value.min.y, value.max.x, value.max.y))
    if isinstance(value, (v2i, v2f)):
        return ConstFrameFunc((value.x, value.y, 0.0, 0.0))
    if isinstance(value, tuple):
        if not value:
            raise ValueError('An empty tuple was passed.')
        if len(value) > 4:
            raise ValueError('Tuples may have at most four entries.')
        return ConstFrameFunc(tuple(float(x) for x in value))
    # A bare number
    return ConstFrameFunc((float(value), 0.0, 0.0, 0.0))


# --- typed single-frame evaluation (basicframefuncs.c:270-347) --------------

def _eval1(func, frame):
    return func.get_values_array(np.asarray([float(frame)]))[0]


def _lround(x):
    """C lround: round half away from zero."""
    return int(np.sign(x) * np.floor(np.abs(x) + 0.5))


def get_i32(func, frame):
    return _lround(_eval1(func, frame)[0])


def get_f32(func, frame):
    return float(np.float32(_eval1(func, frame)[0]))


def get_v2f(func, frame):
    vals = _eval1(func, frame)
    return v2f(float(np.float32(vals[0])), float(np.float32(vals[1])))


def get_box2i(func, frame):
    vals = _eval1(func, frame)
    return box2i(_lround(vals[0]), _lround(vals[1]),
                 _lround(vals[2]), _lround(vals[3]))


def get_rgba_f32(func, frame):
    vals = _eval1(func, frame).astype(np.float32)
    return rgba(float(vals[0]), float(vals[1]), float(vals[2]),
                float(np.clip(vals[3], 0.0, 1.0)))


# --- batched evaluation (used by the render planner) -------------------------

def _lround_array(x):
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(np.int64)


def get_box2i_array(func, frames):
    """Vectorized get_box2i over a frame array -> (N, 4) int64 array
    [x0, y0, x1, y1] (window-array form, see render.windows_to_array)."""
    vals = func.get_values_array(np.asarray(frames, dtype=np.float64))
    return _lround_array(vals)[:, :4]


def get_v2f_array(func, frames):
    """Vectorized get_v2f -> float32 (N, 2) array."""
    vals = func.get_values_array(np.asarray(frames, dtype=np.float64))
    return vals[:, :2].astype(np.float32).astype(np.float64)


def get_f32_array(func, frames):
    vals = func.get_values_array(np.asarray(frames, dtype=np.float64))
    return vals[:, 0].astype(np.float32)
