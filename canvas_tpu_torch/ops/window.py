"""Window placement ops of the pull path: fill, re-window and dtype
conversion (``canvas_tpu/ops/window.py``), each with a NumPy arm and a
torch arm.

Frames are channel-planar ``(4, H, W)`` arrays; coordinate ``(x, y)``
maps to element ``[:, y - full.min.y, x - full.min.x]``. Every op keeps
pixels outside the current window at zero. ``fill_solid`` picks its arm
by ``backend.use_torch_for``; ``place`` and ``convert`` follow their
input (a tensor stays on its device).
"""

import numpy as np
import torch

from canvas_tpu_torch import backend
from canvas_tpu_torch.basetypes import box2i_intersect

__all__ = ['blank', 'fill_solid', 'place', 'convert', 'window_slices']


def blank(window, dtype):
    """Zeros array for a full_window (NumPy; the ops promote it)."""
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
    full_window (it is clipped). The torch arm casts the color to f32 and
    then to *dtype*, as the JAX arm does (``_fill_jax``), and fills each
    channel with its value (no copy from the host).
    """
    shape = (4, full_window.height, full_window.width)
    clipped = box2i_intersect(fill_box, full_window)
    dev = backend.torch_device_for(shape)
    if dev is not None:
        out = torch.zeros(shape, dtype=backend.torch_dtype(dtype), device=dev)
        if not clipped.empty():
            sl = window_slices(full_window, clipped)
            c = np.asarray(color, np.float32).astype(dtype)
            for ch in range(4):
                out[ch, sl[0], sl[1]] = float(c[ch])
        return out
    out = np.zeros(shape, dtype=dtype)
    if not clipped.empty():
        sl = window_slices(full_window, clipped)
        out[:, sl[0], sl[1]] = np.asarray(color, dtype=dtype)[:, None, None]
    return out


def place(src, src_window, dst_window, copy_box):
    """Map *src* (full_window=src_window) into a dst_window-sized array.

    copy_box (absolute coords) is the region guaranteed valid — normally
    ``intersect(src_current, dst_window)``. Pixels of dst outside the mapped
    src stay zero; src's own zero-outside-current invariant carries over.
    The result never aliases *src*, and a tensor *src* gives a tensor on
    its device.
    """
    dst_shape = (4, dst_window.height, dst_window.width)
    if src_window == dst_window and not copy_box.empty():
        # identity mapping (value-correct under the caller contract)
        return src.clone() if isinstance(src, torch.Tensor) else src.copy()
    if isinstance(src, torch.Tensor):
        out = torch.zeros(dst_shape, dtype=src.dtype, device=src.device)
    else:
        out = np.zeros(dst_shape, dtype=src.dtype)
    if not copy_box.empty():
        src_sl = window_slices(src_window, copy_box)
        dst_sl = window_slices(dst_window, copy_box)
        out[:, dst_sl[0], dst_sl[1]] = src[:, src_sl[0], src_sl[1]]
    return out


def convert(arr, dtype):
    """*arr* in *dtype* (a NumPy dtype), itself when it already is."""
    if isinstance(arr, torch.Tensor):
        want = backend.torch_dtype(dtype)
        return arr if arr.dtype == want else arr.to(want)
    if arr.dtype == dtype:
        return arr
    return arr.astype(dtype)
