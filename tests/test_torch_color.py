"""The port's f16 quantizers and transfer curves
(canvas_tpu_torch.ops.color) against the JAX package's on the CPU.

Tolerances:

- ``quantize_f16`` and ``quantize_f16_trunc``: exact (every bit; a NaN
  only has to stay NaN), over all 65536 f16 bit patterns plus seeded f32
  values across the whole range, subnormals, the 65504-65536 edge,
  +/-inf and NaN.
- ``device_transfer`` (a gather from the f16 LUT), over every finite
  f16 input, against ``canvas_tpu.render._device_transfer`` (direct
  ``pow`` math on CPU JAX): at least 99.9% bit-equal and at most one f16
  ulp apart (an f32 ``pow`` one ulp apart from the table's ``powf``
  becomes one f16 ulp after truncation); and exact against the NumPy
  pull path's table (``color.get_lut``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from canvas_tpu import render as ref_render
from canvas_tpu.ops import color as ref_color
from canvas_tpu_torch.ops import color

ALL_F16 = np.arange(65536, dtype=np.uint16).view(np.float16).astype(
    np.float32)
FINITE_F16 = ALL_F16[np.isfinite(ALL_F16)]


def _f32_inputs():
    rng = np.random.default_rng(61)
    mags = 10.0 ** rng.uniform(-10, 6, 200000)
    signs = rng.choice([-1.0, 1.0], 200000)
    edge = np.linspace(65500.0, 65540.0, 4001)
    special = [np.inf, -np.inf, np.nan, 0.0, -0.0, 2.0 ** -24, 2.0 ** -25,
               3 * 2.0 ** -26, 2.0 ** -14, 2.0 ** -14 * (1 - 2.0 ** -11),
               65504.0, 65519.99, 65520.0, 65535.99, 65536.0, 1e30]
    with np.errstate(invalid='ignore'):
        return np.concatenate([ALL_F16, mags * signs, edge, -edge,
                               special]).astype(np.float32)


def _same_bits(a, b):
    return ((a.view(np.uint32) == b.view(np.uint32))
            | (np.isnan(a) & np.isnan(b)))


@pytest.mark.parametrize('name', ['quantize_f16', 'quantize_f16_trunc'])
def test_quantizers_match_jax_exactly(name):
    x = _f32_inputs()
    ref = getattr(ref_color, name)
    want = np.asarray(jax.jit(lambda v: ref(v, jnp, jax))(jnp.asarray(x)))
    got = getattr(color, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    bad = ~_same_bits(got, want)
    assert not bad.any(), (x[bad][:8], got[bad][:8], want[bad][:8])
    if name == 'quantize_f16_trunc':
        # the pull path's truncating conversion, on the host
        host = ref_color.float_to_half_trunc(x).astype(np.float32)
        assert _same_bits(got, host).all()
        assert got[x == 65535.99][0] == 65504.0
        assert np.isinf(got[x == 65536.0][0])


def _ulps(a, b):
    ai = a.astype(np.float16).view(np.int16).astype(np.int32)
    bi = b.astype(np.float16).view(np.int16).astype(np.int32)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize('name', color.TRANSFERS)
def test_device_transfer_matches_jax_and_pull(name):
    want = np.asarray(jax.jit(
        lambda v: ref_render._device_transfer(name, v, jnp, jax))(
            jnp.asarray(FINITE_F16)))
    got = color.device_transfer(name, torch.from_numpy(FINITE_F16)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    equal = _same_bits(got, want).mean()
    assert equal >= 0.999, equal
    assert _ulps(got, want) <= 1
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    table = ref_color.get_lut(name)
    pull = ref_color.apply_half_lut(FINITE_F16.astype(np.float16),
                                    table).astype(np.float32)
    assert _same_bits(got, pull).all()


def test_device_transfer_takes_any_grid_dtype_and_shape():
    x = torch.from_numpy(FINITE_F16[:4 * 6 * 5].reshape(4, 6, 5))
    a = color.device_transfer('linear_to_srgb', x)
    b = color.device_transfer('linear_to_srgb', x.half())
    assert a.shape == (4, 6, 5) and torch.equal(a, b)
    with pytest.raises(ValueError, match='unknown transfer'):
        color.device_transfer('gamma', x)


@pytest.mark.parametrize('H, W', [(128, 128), (181, 321), (7, 5)])
@pytest.mark.parametrize('post', ['rgba_u8', 'bgra_u8', 'yuv420'])
def test_posts_match_jax(post, H, W):
    """The export conversions on every f16 bit pattern (128x128) and on
    seeded frames of odd sizes against the JAX package's ``_u8_math`` /
    ``_yuv420_pack_studio_math`` over the same f16 frames: shapes exact,
    u8 values within 1 on at most 0.1% of them (x ** 0.45 next to a u8
    step; measured: all equal on this CPU)."""
    if H == 128:
        x = ALL_F16.astype(np.float16).reshape(1, 4, 128, 128)
    else:
        x = np.random.default_rng(H).uniform(-0.1, 1.3, (3, 4, H, W)).astype(
            np.float16)
    xj = jnp.asarray(x.astype(np.float32))
    if post == 'yuv420':
        want = np.asarray(ref_color._yuv420_pack_studio_math(xj))
    else:
        order = (2, 1, 0, 3) if post == 'bgra_u8' else (0, 1, 2, 3)
        want = np.asarray(ref_color._u8_math(xj, order))
    got = color.POSTS[post](torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff != 0) <= 1e-3
