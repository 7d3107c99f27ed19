"""Window placement ops of the pull path: fill, re-window and dtype
conversion on NumPy (the NumPy arm of ``canvas_tpu/ops/window.py``).

Frames are channel-planar ``(4, H, W)`` arrays; coordinate ``(x, y)``
maps to element ``[:, y - full.min.y, x - full.min.x]``. Every op keeps
pixels outside the current window at zero.
"""

import numpy as np

from canvas_tpu_torch.basetypes import box2i_intersect

__all__ = ['blank', 'fill_solid', 'place', 'convert', 'window_slices']


def blank(window, dtype):
    """Zeros array for a full_window."""
    return np.zeros((4, window.height, window.width), dtype=dtype)


def window_slices(full_window, box):
    """(row_slice, col_slice) of *box* (absolute coords) within *full_window*.

    The caller must ensure box ⊆ full_window (intersect first).
    """
    return (slice(box.min.y - full_window.min.y, box.max.y - full_window.min.y + 1),
            slice(box.min.x - full_window.min.x, box.max.x - full_window.min.x + 1))


def fill_solid(full_window, dtype, color, fill_box):
    """Array for *full_window* holding *color* inside *fill_box*, zero outside.

    fill_box is in absolute coordinates and may be empty or extend beyond
    full_window (it is clipped).
    """
    out = np.zeros((4, full_window.height, full_window.width), dtype=dtype)
    clipped = box2i_intersect(fill_box, full_window)
    if not clipped.empty():
        sl = window_slices(full_window, clipped)
        out[:, sl[0], sl[1]] = np.asarray(color, dtype=dtype)[:, None, None]
    return out


def place(src, src_window, dst_window, copy_box):
    """Map *src* (full_window=src_window) into a dst_window-sized array.

    copy_box (absolute coords) is the region guaranteed valid — normally
    ``intersect(src_current, dst_window)``. Pixels of dst outside the mapped
    src stay zero; src's own zero-outside-current invariant carries over.
    The result never aliases *src*.
    """
    dst_shape = (4, dst_window.height, dst_window.width)
    if copy_box.empty():
        return np.zeros(dst_shape, dtype=src.dtype)
    if src_window == dst_window:
        # identity mapping (value-correct under the caller contract)
        return src.copy()
    src_sl = window_slices(src_window, copy_box)
    dst_sl = window_slices(dst_window, copy_box)
    out = np.zeros(dst_shape, dtype=src.dtype)
    out[:, dst_sl[0], dst_sl[1]] = src[:, src_sl[0], src_sl[1]]
    return out


def convert(arr, dtype):
    if arr.dtype == dtype:
        return arr
    return arr.astype(dtype)
