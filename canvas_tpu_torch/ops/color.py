"""Color on the host and on torch tensors: the port's counterpart of
``canvas_tpu/ops/color.py`` (gammatab.c, color.c, half.c).

The host half is the JAX package's NumPy code: the reference's
truncating f32 -> f16 conversion, the 65536-entry f16 transfer tables
built with libm's ``powf`` (bit-identical to the reference binary's),
their gather, the gamma45 display ramp and the colour matrices. The
pull path and the planner use it.

The torch half runs on the device:

- ``quantize_f16`` / ``quantize_f16_trunc`` (color.py:422-471). The TPU
  recipe for the round-to-nearest quantize (``reduce_precision`` plus an
  explicit subnormal grid) exists because XLA folds an f32 -> f16 -> f32
  convert pair inside a fused program. Eager PyTorch folds nothing, and
  ``.to(torch.float16)`` rounds to nearest even with correct subnormals
  and overflow on the CPU and on CUDA, so the cast is the quantize here.
- ``device_transfer`` (render.py:715-746) applies a transfer curve as a
  gather from the host's f16 table, indexed by the f16 bits: bit-exact
  with the pull path by construction. The TPU path computes the curve
  with direct ``pow`` math instead, because a gather is slow there. On
  an NVIDIA H100 (80GB HBM3, 700 W) the gather took 0.44 ms and the same
  ``pow`` math in eager torch 1.16 ms on a (16, 4, 480, 720) DV batch
  (PERF.md).
- ``POSTS``: the export conversions of ``iter_batches(post=...)``
  (``_u8_math`` color.py:551-558, ``_yuv420_pack_studio_math``
  628-656) in plain torch ops, applied to the f16 frames.
- The display transports of ``render_display`` and the playback
  engine: ``display_u8`` (``_display_u8_math``, color.py:521-533),
  ``yuv420_pack`` (``_yuv420_pack_math``, 575-608) and the gamma45
  ``u8_interleaved``, with their host inverses ``rgb24_unpack`` and
  ``yuv420_unpack`` and the host display ramp (``apply_display_u8``).

Transfer curves (gammatab.c:38-250):
  rec709_to_linear (scene):   x < 4.5*0.018 ? x/4.5 : ((x+0.099)/1.099)^(1/0.45)
  rec709_to_linear (display): x < 0 ? 0 : x^2.5
  linear_to_rec709:           x < 0.018 ? 4.5x : 1.099*x^0.45 - 0.099
  linear_to_srgb:             x <= 0.0031308 ? 12.92x : 1.055*x^(1/2.4) - 0.055
  gamma45 ramp (u8):          clamp(x^0.45 * 255, 0, 255)  (gammatab.c:8-10)
"""

import functools
import math
import threading

import numpy as np
import torch

__all__ = [
    'rec709_to_linear_scene', 'rec709_to_linear_display',
    'linear_to_rec709', 'linear_to_srgb',
    'transfer_rec709_to_linear_scene', 'transfer_rec709_to_linear_display',
    'transfer_linear_to_rec709', 'transfer_linear_to_srgb',
    'gamma45_ramp_u8', 'apply_gamma45_u8',
    'RGB_TO_XYZ_SDTV', 'XYZ_TO_SRGB',
    'color_matrix', 'rgb_to_xyz_sdtv_frame', 'xyz_to_srgb_frame',
    'build_half_lut', 'apply_half_lut', 'float_to_half_trunc', 'get_lut',
    'TRANSFERS', 'quantize_f16', 'quantize_f16_trunc', 'device_transfer',
    'u8_interleaved', 'yuv420_pack_studio', 'POSTS',
    'display_ramp_u8', 'apply_display_u8', 'display_u8', 'yuv420_pack',
    'rgb24_unpack', 'yuv420_unpack', 'yuv420_unpack_batch',
]


def float_to_half_trunc(f):
    """The reference's f32 -> f16 conversion, which TRUNCATES the mantissa.

    half_convert_from_float applies the van der Zijp base/shift tables
    (half.c:36-48 via genhalf.py:27-56):
    ``h = base[bits>>23] + ((bits & 0x7fffff) >> shift[bits>>23])`` —
    round-toward-zero, not round-to-nearest. Every transfer LUT and every
    f32->f16 frame conversion in the C engine uses it, so matching its
    rounding is what makes our tables bit-identical to the reference
    binary's (verified exhaustively in tests/test_cref_parity.py).

    Reproduced here as arithmetic on the bit patterns (vectorized) rather
    than the 512-entry tables. NaN payloads confined to the low 13
    mantissa bits collapse to infinity — the reference's own artifact,
    preserved.
    """
    bits = np.asarray(f, np.float32).view(np.uint32)
    sign = ((bits >> np.uint32(16)) & np.uint32(0x8000)).astype(np.uint32)
    e = ((bits >> np.uint32(23)) & np.uint32(0xff)).astype(np.int32) - 127
    m = (bits & np.uint32(0x007fffff)).astype(np.uint32)

    base = np.zeros_like(bits)
    shift = np.full(bits.shape, 24, np.uint32)

    sub = (e >= -24) & (e < -14)      # half-subnormal range
    sub_amt = np.clip(-14 - e, 0, 31).astype(np.uint32)
    base = np.where(sub, np.uint32(0x0400) >> sub_amt, base)
    shift = np.where(sub, np.clip(-e - 1, 0, 31).astype(np.uint32), shift)

    norm = (e >= -14) & (e <= 15)     # normal range
    base = np.where(norm, (np.clip(e + 15, 0, 31).astype(np.uint32)
                           << np.uint32(10)), base)
    shift = np.where(norm, np.uint32(13), shift)

    big = (e > 15) & (e < 128)        # overflow -> inf
    base = np.where(big, np.uint32(0x7c00), base)
    shift = np.where(big, np.uint32(24), shift)

    infnan = (e == 128)               # inf/NaN keep (shifted) payload
    base = np.where(infnan, np.uint32(0x7c00), base)
    shift = np.where(infnan, np.uint32(13), shift)

    h = (sign | base) + (m >> shift)
    return h.astype(np.uint16).view(np.float16).reshape(np.shape(f))


# libm's powf for LUT construction: the reference builds its tables at
# runtime with powf (gammatab.c), and numpy's float32 power differs from
# glibc powf in the last f32 ulp on a handful of the 65536 inputs — just
# enough to flip one truncated f16 table entry. Table builds are one-time
# and cached, so the per-element ctypes call cost is irrelevant.
_powf = None


def _libm_powf():
    global _powf
    if _powf is None:
        try:
            import ctypes
            import ctypes.util
            libm = ctypes.CDLL(ctypes.util.find_library('m') or 'libm.so.6')
            cf = libm.powf
            cf.restype = ctypes.c_float
            cf.argtypes = [ctypes.c_float, ctypes.c_float]

            def powf_elementwise(x, p):
                x = np.asarray(x, np.float32)
                out = np.empty_like(x)
                flat_in = x.ravel()
                flat_out = out.ravel()
                for i in range(flat_in.size):
                    flat_out[i] = cf(float(flat_in[i]), p)
                return out

            _powf = powf_elementwise
        except Exception:  # pragma: no cover - no libm: keep np.power
            _powf = lambda x, p: np.power(  # noqa: E731
                np.asarray(x, np.float32), np.float32(p))
    return _powf


def _exact_lut_fns():
    """Transfer formulas evaluated with libm powf, for table construction
    only (the fast array paths keep np.power)."""
    powf = _libm_powf()

    def scene(x):
        x = np.asarray(x, np.float32)
        with np.errstate(all='ignore'):
            hi = powf((x + np.float32(0.099)) / np.float32(1.099),
                      1.0 / 0.45)
        return np.where(x < np.float32(4.5) * np.float32(0.018),
                        x / np.float32(4.5), hi).astype(np.float32)

    def display(x):
        x = np.asarray(x, np.float32)
        with np.errstate(all='ignore'):
            hi = powf(x, 2.5)
        return np.where(x < 0.0, np.float32(0.0), hi).astype(np.float32)

    def to709(x):
        x = np.asarray(x, np.float32)
        with np.errstate(all='ignore'):
            hi = (np.float32(1.099) * powf(x, 0.45) - np.float32(0.099))
        return np.where(x < np.float32(0.018),
                        x * np.float32(4.5), hi).astype(np.float32)

    def tosrgb(x):
        x = np.asarray(x, np.float32)
        a = np.float32(0.055)
        with np.errstate(all='ignore'):
            hi = (np.float32(1.0) + a) * powf(x, 1.0 / 2.4) - a
        return np.where(x <= np.float32(0.0031308),
                        x * np.float32(12.92), hi).astype(np.float32)

    return {
        'rec709_to_linear_scene': scene,
        'rec709_to_linear_display': display,
        'linear_to_rec709': to709,
        'linear_to_srgb': tosrgb,
    }


# --- scalar transfer formulas (f32 in, f32 out) ------------------------------

def rec709_to_linear_scene(x):
    x = np.asarray(x, dtype=np.float32)
    transition = np.float32(4.5) * np.float32(0.018)
    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        lo = x / np.float32(4.5)
        hi = np.power((x + np.float32(0.099)) / np.float32(1.099),
                      np.float32(1.0) / np.float32(0.45))
    return np.where(x < transition, lo, hi).astype(np.float32)


def rec709_to_linear_display(x):
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid='ignore'):
        hi = np.power(x, np.float32(2.5))
    return np.where(x < 0.0, np.float32(0.0), hi).astype(np.float32)


def linear_to_rec709(x):
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid='ignore'):
        hi = np.float32(1.099) * np.power(x, np.float32(0.45)) - np.float32(0.099)
    return np.where(x < np.float32(0.018),
                    x * np.float32(4.5), hi).astype(np.float32)


def linear_to_srgb(x):
    x = np.asarray(x, dtype=np.float32)
    a = np.float32(0.055)
    with np.errstate(invalid='ignore'):
        hi = (np.float32(1.0) + a) * np.power(x, np.float32(1.0 / 2.4)) - a
    return np.where(x <= np.float32(0.0031308),
                    x * np.float32(12.92), hi).astype(np.float32)


def _gamma45_u8_of_f32(x):
    """clamp(x**0.45 * 255, 0, 255) truncated to u8 (gammatab.c:8-10).

    NaN (from pow of negative input) maps to 0 like the C clamp+cast does
    on our targets.
    """
    with np.errstate(invalid='ignore'):
        y = np.power(x.astype(np.float32), np.float32(0.45)) * np.float32(255.0)
    y = np.clip(y, 0.0, 255.0)
    return np.nan_to_num(y, nan=0.0).astype(np.uint8)


# --- half-LUT machinery (half.c / gammatab.c table pattern) ------------------

_ALL_HALF_BITS = None


def _all_half_values():
    """float32 value of every one of the 65536 f16 bit patterns."""
    global _ALL_HALF_BITS
    if _ALL_HALF_BITS is None:
        _ALL_HALF_BITS = np.arange(65536, dtype=np.uint16).view(
            np.float16).astype(np.float32)
    return _ALL_HALF_BITS


def build_half_lut(fn, out_dtype=np.float16):
    """65536-entry table: out[bits] = out_dtype(fn(float(half_from_bits))).

    Exactly the table-construction loop the reference uses for every
    transfer curve (gammatab.c:85-105 etc.) — including its f32->f16
    conversion, which TRUNCATES (float_to_half_trunc), so f16 tables come
    out bit-identical to the reference binary's. Inf/NaN half inputs flow
    through the same arithmetic as the C tables; their conversions are
    intentionally unchecked."""
    with np.errstate(invalid='ignore', over='ignore', divide='ignore'):
        out = np.asarray(fn(_all_half_values()))
        if np.dtype(out_dtype) == np.float16:
            return float_to_half_trunc(out.astype(np.float32))
        return out.astype(out_dtype)


def apply_half_lut(arr, table):
    """Gather table[bits(x)] over an f16 array (half_lookup,
    half.c:98-107); result dtype = table dtype."""
    arr = np.asarray(arr, dtype=np.float16)
    return table[arr.view(np.uint16)]


class _LutCache:
    """Lazily-built named transfer LUTs (the reference's g_once statics).

    The four named transfer curves build from the libm-powf exact
    formulas (_exact_lut_fns) so the resulting tables match the
    reference binary's bit-for-bit; ad-hoc tables use the fn given."""

    def __init__(self):
        self._tables = {}

    def get(self, name, fn, out_dtype=np.float16):
        key = (name, np.dtype(out_dtype).name)
        table = self._tables.get(key)
        if table is None:
            exact = _exact_lut_fns().get(name)
            table = build_half_lut(exact if exact is not None else fn,
                                   out_dtype)
            self._tables[key] = table
        return table


_luts = _LutCache()


def get_lut(name, out_dtype=np.float16):
    """Named transfer LUT from the shared cache (bit-identical to the
    reference binary's tables for the four gammatab curves)."""
    fns = {
        'rec709_to_linear_scene': rec709_to_linear_scene,
        'rec709_to_linear_display': rec709_to_linear_display,
        'linear_to_rec709': linear_to_rec709,
        'linear_to_srgb': linear_to_srgb,
        'gamma45_u8': _gamma45_u8_of_f32,
    }
    return _luts.get(name, fns[name],
                     np.uint8 if name.endswith('_u8') else out_dtype)


def _transfer(arr, name, fn):
    """Apply a named transfer curve with reference-exact semantics.

    f16 input -> f16 LUT gather (bit-exact vs the C tables).
    f32 input -> direct formula (float32 math).
    """
    dtype = np.dtype(getattr(arr, 'dtype', np.float32))
    if dtype == np.float16:
        return apply_half_lut(arr, _luts.get(name, fn))
    return fn(np.asarray(arr, dtype=np.float32))


def transfer_rec709_to_linear_scene(arr):
    return _transfer(arr, 'rec709_to_linear_scene', rec709_to_linear_scene)


def transfer_rec709_to_linear_display(arr):
    return _transfer(arr, 'rec709_to_linear_display', rec709_to_linear_display)


def transfer_linear_to_rec709(arr):
    return _transfer(arr, 'linear_to_rec709', linear_to_rec709)


def transfer_linear_to_srgb(arr):
    return _transfer(arr, 'linear_to_srgb', linear_to_srgb)


def gamma45_ramp_u8():
    """The 65536-entry f16-bits -> u8 display ramp (gammatab.c:12-37)."""
    return _luts.get('gamma45_u8', _gamma45_u8_of_f32, np.uint8)


def apply_gamma45_u8(arr):
    """f16 (or convertible) array -> u8 via the gamma45 ramp."""
    return apply_half_lut(np.asarray(arr, dtype=np.float16),
                          gamma45_ramp_u8())


def display_ramp_u8(intent):
    """The widget display ramp: 65536-entry f16-bits -> u8 table
    ``lrint(clamp(pow(f, intent) * 255, 0, 255))``
    (widget_gl_set_rendering_intent, widget_gl.c:950-969; default
    intent 1.25)."""
    def fn(x):
        with np.errstate(invalid='ignore'):
            y = np.power(x.astype(np.float32), np.float32(intent))
        y = np.clip(y * np.float32(255.0), 0.0, 255.0)
        return np.rint(np.nan_to_num(y, nan=0.0)).astype(np.uint8)
    return _luts.get('display_u8_%r' % (float(intent),), fn, np.uint8)


def apply_display_u8(arr, intent=1.25):
    """Host widget_gl soft-mode display conversion: linear f16 -> sRGB
    transfer (all 4 channels, the LUT quirk) -> rendering-intent ramp ->
    u8 (widget_gl.c:291-308). Returns u8, same shape."""
    srgb = transfer_linear_to_srgb(arr)
    return apply_half_lut(srgb, display_ramp_u8(intent))


def rgb24_unpack(flat3, order=(2, 1, 0, 3)):
    """Host inverse of the rgb24 display transport: (..., W*3) u8
    color-only rows -> (..., W, 4) u8 in channel *order*, alpha forced
    255. The device packed the color channels in order-minus-alpha, so
    the color bytes land at the non-alpha positions of *order*.
    ``render_display`` and the playback engine share it. *flat3* is
    numpy or a CPU tensor; the copy runs as torch ops, which spread over
    the host's cores (the playback engine unpacks every frame here)."""
    rgb = torch.as_tensor(flat3)
    rgb = rgb.reshape(rgb.shape[:-1] + (-1, 3))
    out = torch.empty(rgb.shape[:-1] + (4,), dtype=torch.uint8)
    colors = iter(range(3))
    for i, c in enumerate(order):
        out[..., i] = 255 if c == 3 else rgb[..., next(colors)]
    return out.numpy()


def yuv420_unpack(flat, h, w, order=(2, 1, 0, 3)):
    """Host inverse of ``yuv420_pack`` for ONE frame: (N,) u8 ->
    (h, w, 4) u8 in channel *order*, alpha forced 255."""
    return yuv420_unpack_batch(np.asarray(flat)[None], h, w, order)[0]


def yuv420_unpack_batch(packed, h, w, order=(2, 1, 0, 3)):
    """``yuv420_unpack`` of every frame of (B, N) u8 host bytes (numpy or
    a CPU tensor) -> (B, h, w, 4) u8 numpy.

    The JAX package's f32 math (color.py:674-688) value for value, run
    as torch ops on the CPU, which spread over its cores (the playback
    engine unpacks every frame of its quality <= 5 preview here). The
    chroma terms are computed at 2x2-block resolution and spread over
    their blocks, and each channel is rounded straight into the output:
    the same bytes."""
    f = torch.as_tensor(packed)
    B = f.shape[0]
    h2, w2 = (h + 1) // 2, (w + 1) // 2

    def chroma(lo, scale):
        c = (f[:, lo:lo + h2 * w2].reshape(B, h2, w2).float() - 128.0) / scale
        return c[:, :, None, :, None].expand(B, h2, 2, w2, 2).reshape(
            B, 2 * h2, 2 * w2)[:, :h, :w].contiguous()

    # In place where the JAX expression allows it (a + b is b + a in
    # IEEE f32): every full-frame temporary is a fresh allocation the
    # host pays for in page faults.
    Y = f[:, :h * w].reshape(B, h, w).float()
    R = chroma(h * w + h2 * w2, 0.713).add_(Y)
    Bl = chroma(h * w, 0.564).add_(Y)
    t = torch.mul(R, 0.299)
    G = Y.sub_(t).sub_(torch.mul(Bl, 0.114, out=t)).div_(0.587)
    out = torch.empty((B, h, w, 4), dtype=torch.uint8)
    for i, c in enumerate(order):
        if c == 3:
            out[..., i] = 255
        else:
            out[..., i] = (R, G, Bl)[c].round_().clamp_(0.0, 255.0)
    return out.numpy()


# --- color matrices ----------------------------------------------------------

# Rows are output components, columns input components (color.c:35-43 is
# column-major; these are the same matrices expressed row-major).
RGB_TO_XYZ_SDTV = np.array([
    [0.3936, 0.3652, 0.1916],
    [0.2124, 0.7010, 0.0865],
    [0.0187, 0.1119, 0.9582]], dtype=np.float32)

XYZ_TO_SRGB = np.array([
    [3.2410, -1.5374, -0.4986],
    [-0.9692, 1.8760, 0.0416],
    [0.0556, -0.2040, 1.0570]], dtype=np.float32)


def color_matrix(data, matrix):
    """Apply a 3x3 matrix to the rgb planes of (4, H, W) data in f32;
    alpha passes through. Returns the input's dtype (f16 data is
    converted f16->f32->matrix->f16 like color.c:134-141)."""
    dtype = data.dtype
    m = np.asarray(matrix, dtype=np.float32)
    rgb = np.asarray(data[:3], dtype=np.float32)
    out = np.einsum('ij,jhw->ihw', m, rgb)
    return np.concatenate([out.astype(dtype), data[3:]], axis=0)


def rgb_to_xyz_sdtv_frame(data):
    """video_color_rgb_to_xyz_sdtv (color.c:104-142): rec709->linear scene
    transfer on ALL FOUR channels, then the SDTV RGB->XYZ matrix on rgb.
    data: (4, H, W) f16."""
    lin = transfer_rec709_to_linear_scene(data)
    return color_matrix(lin, RGB_TO_XYZ_SDTV)


def xyz_to_srgb_frame(data):
    """video_color_xyz_to_srgb (color.c:145-168): XYZ->sRGB matrix on rgb,
    then linear->sRGB transfer on all four channels. data: (4, H, W) f16."""
    out = color_matrix(data, XYZ_TO_SRGB)
    return transfer_linear_to_srgb(out)


# --- torch (device) half ----------------------------------------------------

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
            host = torch.from_numpy(get_lut(name))
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


# --- export conversions (iter_batches(post=...)) ----------------------------

def _gamma45_floor(x16):
    """f16 frames -> the u8 values of the gamma45 ramp as f32:
    floor(clip(x ** 0.45 * 255, 0, 255)), NaN -> 0 (color.py:553-556)."""
    return torch.floor(_display_levels(x16, None))


def _interleave(u8, order):
    """(B, 4, H, W) u8 -> (B, H, W*len(order)) rows of the channels in
    *order*."""
    u8 = u8[:, list(order)]
    B, C, H, W = u8.shape
    return u8.permute(0, 2, 3, 1).reshape(B, H, W * C)


def u8_interleaved(x16, order):
    """(B, 4, H, W) f16 frames -> (B, H, W*len(order)) u8 rows, the
    channels interleaved in *order* (``_u8_math``, color.py:551-558);
    three channels for the rgb24 display transport."""
    return _interleave(_gamma45_floor(x16).to(torch.uint8), order)


def _edge_pad_even(c):
    """Repeat the last row and column of (B, H, W) up to even H and W."""
    if c.shape[1] % 2:
        c = torch.cat([c, c[:, -1:]], dim=1)
    if c.shape[2] % 2:
        c = torch.cat([c, c[:, :, -1:]], dim=2)
    return c


def yuv420_pack_studio(x16):
    """(B, 4, H, W) f16 frames -> (B, H*W + 2*ceil(H/2)*ceil(W/2)) u8:
    studio-range 4:2:0 (Y 16-235, Cb/Cr 16-240, BT.601 matrix) of the
    gamma45 u8 RGB, chroma the 2x2 mean after an edge-replicate pad of
    odd sizes (``_yuv420_pack_studio_math``, color.py:628-656)."""
    u8f = _gamma45_floor(x16)
    R, G, Bl = u8f[:, 0], u8f[:, 1], u8f[:, 2]
    Ey = (0.299 * R + 0.587 * G + 0.114 * Bl) / 255.0
    Y = 16.0 + 219.0 * Ey
    Cb = 128.0 + 224.0 * 0.5 / 0.886 * (Bl / 255.0 - Ey)
    Cr = 128.0 + 224.0 * 0.5 / 0.701 * (R / 255.0 - Ey)
    B = Y.shape[0]

    def sub(c):
        c = _edge_pad_even(c)
        h2, w2 = c.shape[1] // 2, c.shape[2] // 2
        return c.reshape(B, h2, 2, w2, 2).mean(dim=(2, 4))

    def q(c, hi):
        return torch.round(torch.clamp(c, 16.0, hi)).to(torch.uint8) \
            .reshape(B, -1)

    return torch.cat([q(Y, 235.0), q(sub(Cb), 240.0), q(sub(Cr), 240.0)],
                     dim=1)


# --- display transports (render_display, the playback engine) ------------

@functools.lru_cache(maxsize=8)
def _levels_table(intent, device):
    """The display levels of every f16 bit pattern at *intent* (None, or
    a float) as a 65,536-entry f32 table on *device* (a string): the
    gamma45 ramp ``x ** 0.45 * 255`` for None; else the widget_gl soft
    mode, linear -> sRGB, truncated to the f16 grid like a hit in the
    host's sRGB table, then ``pow(intent) * 255`` (color.py:524-530,
    578-587); NaN -> 0, clamped to [0, 255]. Built on the host in f32,
    in that order, with libm's ``powf``, which is what XLA computes on
    the CPU bit for bit; ``torch.pow`` is an ulp or two away on ~2% of
    inputs. The few most recent (intent, device) tables are kept."""
    powf = _libm_powf()
    x = _all_half_values()
    f32 = np.float32
    with np.errstate(all='ignore'):
        if intent is None:
            y = powf(x, 0.45) * f32(255.0)
        else:
            s = np.where(x <= f32(0.0031308), x * f32(12.92),
                         f32(1.055) * powf(x, 1.0 / 2.4) - f32(0.055))
            s = float_to_half_trunc(s).astype(f32)
            y = powf(s, intent) * f32(255.0)
        y = np.clip(np.nan_to_num(y, nan=0.0), 0.0, 255.0)
    return torch.from_numpy(y.astype(f32)).to(device)


def _display_levels(x16, intent):
    """f16 frames -> the display's u8 levels as unrounded f32 in
    [0, 255], gathered by the f16 bits from ``_levels_table`` (as
    ``device_transfer`` does): equal to the JAX package's f32 levels on
    every f16 value, so what is rounded or averaged from them comes out
    equal too (tests/test_torch_display.py)."""
    table = _levels_table(None if intent is None else float(intent),
                          str(x16.device))
    bits = x16.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    return table[bits]


def display_u8(x16, intent=1.25, order=(2, 1, 0, 3)):
    """(B, 4, H, W) f16 frames -> (B, H, W*len(order)) interleaved u8
    display rows in channel *order*: the widget_gl soft-mode conversion
    (``_display_u8_math``, color.py:521-533) rounded half to even."""
    return _interleave(torch.round(_display_levels(x16, intent))
                       .to(torch.uint8), order)


def _f32(c):
    """The f32 constant nearest to *c*, as a Python float."""
    return float(np.float32(c))


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (*a* an f32 tensor; *b*, *c*
    tensors or f32-valued floats): the product of two f32 values is exact
    in f64, and the sum is rounded there and then to f32. XLA's CPU code
    contracts a multiply that feeds an add into one fused multiply-add,
    which eager torch cannot ask for, and a display level that lands on
    a rounding tie shows the difference."""
    return (a.double() * b + c).float()


def yuv420_pack(x16, intent=None):
    """(B, 4, H, W) f16 frames -> (B, H*W + 2*ceil(H/2)*ceil(W/2)) u8:
    the LOSSY display transport, full-range BT.601 Y at full resolution
    and the 2x2 mean of Cb/Cr (odd sizes edge-replicated) over the
    display levels of ``intent`` (None: the gamma45 ramp)
    (``_yuv420_pack_math``, color.py:575-608).

    Rounded where the JAX package's code, compiled for the CPU, rounds:
    the Y it writes out rounds after every operation, but the Y inside
    its chroma and the chroma's own multiply-add are fused (``_fma``),
    and the 2x2 sum runs row by row. With that the bytes equal the JAX
    package's on every f16 value and on the seeded odd-sized frames of
    tests/test_torch_display.py; on larger seeded frames at most 1e-5
    of values still differ, by 1 (its compiler's choice there is not
    reproduced). The same bytes on every device."""
    y = _display_levels(x16, intent)
    R, G, Bl = y[:, 0], y[:, 1], y[:, 2]
    Y = 0.299 * R + 0.587 * G + 0.114 * Bl
    Yc = _fma(Bl, _f32(0.114), _fma(R, _f32(0.299), 0.587 * G))
    Cb = _fma(Bl - Yc, _f32(0.564), 128.0)
    Cr = _fma(R - Yc, _f32(0.713), 128.0)
    B = Y.shape[0]

    def q(c):
        return torch.round(c).to(torch.uint8).reshape(B, -1)

    def sub(c):
        c = _edge_pad_even(c)
        top, bottom = c[:, 0::2], c[:, 1::2]
        total = ((top[:, :, 0::2] + top[:, :, 1::2]) + bottom[:, :, 0::2]
                 + bottom[:, :, 1::2])
        return torch.clamp(total / 4.0, 0.0, 255.0)

    return torch.cat([q(Y), q(sub(Cb)), q(sub(Cr))], dim=1)


#: The export conversions of ``iter_batches(post=...)``, on f16 frames.
POSTS = {
    'rgba_u8': lambda x16: u8_interleaved(x16, (0, 1, 2, 3)),
    'bgra_u8': lambda x16: u8_interleaved(x16, (2, 1, 0, 3)),
    'yuv420': yuv420_pack_studio,
}
