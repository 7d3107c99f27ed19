"""The 65,536-entry tables the reference gathers from by f16 bit
pattern: the rec709 -> linear (scene) transfer, truncated to f16 as the
reference C engine's tables are, and the gamma45 export levels
``x ** 0.45 * 255`` in f32. Both are computed with libm's ``powf``."""

import ctypes
import ctypes.util
import functools

import numpy as np


def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library('m') or 'libm.so.6')
    fn = libm.powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]

    def powf(x, p):
        x = np.asarray(x, np.float32)
        out = np.empty_like(x)
        flat_in, flat_out = x.ravel(), out.ravel()
        for i in range(flat_in.size):
            flat_out[i] = fn(float(flat_in[i]), p)
        return out

    return powf


def all_half_values():
    """The f32 value of every f16 bit pattern, in bit order."""
    return np.arange(65536, dtype=np.uint16).view(np.float16).astype(
        np.float32)


def float_to_half_trunc(f):
    """f32 -> f16 rounding toward zero (the reference C engine's
    half_convert_from_float, half.c:36-48), on the bit patterns."""
    bits = np.asarray(f, np.float32).view(np.uint32)
    sign = ((bits >> np.uint32(16)) & np.uint32(0x8000)).astype(np.uint32)
    e = ((bits >> np.uint32(23)) & np.uint32(0xff)).astype(np.int32) - 127
    m = (bits & np.uint32(0x007fffff)).astype(np.uint32)
    base = np.zeros_like(bits)
    shift = np.full(bits.shape, 24, np.uint32)
    sub = (e >= -24) & (e < -14)
    base = np.where(sub, np.uint32(0x0400)
                    >> np.clip(-14 - e, 0, 31).astype(np.uint32), base)
    shift = np.where(sub, np.clip(-e - 1, 0, 31).astype(np.uint32), shift)
    norm = (e >= -14) & (e <= 15)
    base = np.where(norm, np.clip(e + 15, 0, 31).astype(np.uint32)
                    << np.uint32(10), base)
    shift = np.where(norm, np.uint32(13), shift)
    big = (e > 15) & (e < 128)
    base = np.where(big, np.uint32(0x7c00), base)
    shift = np.where(big, np.uint32(24), shift)
    infnan = e == 128
    base = np.where(infnan, np.uint32(0x7c00), base)
    shift = np.where(infnan, np.uint32(13), shift)
    h = (sign | base) + (m >> shift)
    return h.astype(np.uint16).view(np.float16).reshape(np.shape(f))


@functools.lru_cache(maxsize=1)
def rec709_to_linear_scene():
    """f16 table of x < 0.081 ? x / 4.5 : ((x + 0.099) / 1.099) **
    (1 / 0.45), each entry truncated to f16 (gammatab.c)."""
    x = all_half_values()
    powf = _powf()
    with np.errstate(all='ignore'):
        hi = powf((x + np.float32(0.099)) / np.float32(1.099), 1.0 / 0.45)
        y = np.where(x < np.float32(4.5) * np.float32(0.018),
                     x / np.float32(4.5), hi).astype(np.float32)
    return float_to_half_trunc(y)


@functools.lru_cache(maxsize=1)
def gamma45_levels():
    """f32 table of clip(x ** 0.45 * 255, 0, 255), NaN -> 0: the export
    levels before they are floored to u8 (gammatab.c:8-10)."""
    x = all_half_values()
    powf = _powf()
    with np.errstate(all='ignore'):
        y = powf(x, 0.45) * np.float32(255.0)
        y = np.clip(np.nan_to_num(y, nan=0.0), 0.0, 255.0)
    return y.astype(np.float32)
