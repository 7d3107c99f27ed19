"""f16 quantizers and transfer curves on torch tensors: the counterparts
of ``canvas_tpu/ops/color.py``'s ``quantize_f16`` / ``quantize_f16_trunc``
(color.py:422-471) and of ``canvas_tpu/render.py``'s ``_device_transfer``
(render.py:715-746).

The TPU recipe for the round-to-nearest quantize (``reduce_precision``
plus an explicit subnormal grid) exists because XLA folds an
f32 -> f16 -> f32 convert pair inside a fused program. Eager PyTorch
folds nothing, and ``.to(torch.float16)`` rounds to nearest even with
correct subnormals and overflow on the CPU and on CUDA, so the cast is
the quantize here.

``device_transfer`` applies a transfer curve as a gather from the
65536-entry f16 table the NumPy pull path uses (``color_ops.get_lut``),
indexed by the f16 bits: bit-exact with the pull path by construction.
The TPU path computes the curve with direct ``pow`` math instead,
because a gather is slow there. On an NVIDIA H100 (80GB HBM3, 700 W)
the gather took 0.44 ms and the same ``pow`` math in eager torch
1.16 ms on a (16, 4, 480, 720) DV batch (PERF.md).
"""

import math
import threading

import torch

from canvas_tpu.ops import color as color_ops

__all__ = ['TRANSFERS', 'quantize_f16', 'quantize_f16_trunc',
           'device_transfer']

#: The four transfer curves of the batched path (gammatab.c).
TRANSFERS = ('rec709_to_linear_scene', 'rec709_to_linear_display',
             'linear_to_rec709', 'linear_to_srgb')


def quantize_f16(x):
    """f32 -> f16 -> f32, round to nearest even (subnormals kept,
    |x| >= 65520 -> inf, NaN stays NaN); result f32."""
    return x.float().to(torch.float16).float()


def quantize_f16_trunc(x):
    """f32 -> f16 grid with ROUND-TOWARD-ZERO (the reference's
    half_convert_from_float); result f32. Round to nearest, then step
    one grid unit toward zero on the int16 view wherever that overshot
    |x|; |x| >= 65536 maps to +/-inf as the C base table does."""
    xf = x.float()
    h = xf.to(torch.float16)
    bits = h.view(torch.int16)
    over = h.float().abs() > xf.abs()
    out = torch.where(over, bits - 1, bits).view(torch.float16).float()
    big = xf.abs() >= 65536.0
    return torch.where(big, torch.where(xf < 0, -math.inf, math.inf), out)


_tables = {}
_tables_lock = threading.Lock()


def _table(name, device):
    """The f16 LUT of *name* on *device*, uploaded once per device."""
    if name not in TRANSFERS:
        raise ValueError('unknown transfer: %r' % (name,))
    key = (name, str(device))
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            host = torch.from_numpy(color_ops.get_lut(name))
            table = _tables[key] = host.to(device)
    return table


def device_transfer(name, x16):
    """Transfer curve *name* (all four channels, the reference's LUT
    quirk) as a gather from its f16 table by the f16 bits of *x16*
    (values on the f16 grid, any float dtype); f32 out, equal to the
    pull path's ``apply_half_lut``. The counterpart of
    ``render._device_transfer``."""
    table = _table(name, x16.device)
    bits = x16.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    return table[bits].float()
