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
- The display levels (``color._levels_table``, built on the host with
  libm's ``powf``): every one of the 65536 entries bit-equal to the f32
  levels inside the JAX package's ``_display_u8_math`` and
  ``_yuv420_pack_math`` on CPU JAX, for intents None, 1.25 and 0.8; and
  what is rounded from them u8-equal, tolerance 0.
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


def _ref_levels(x, intent):
    """The f32 display levels as ``_display_u8_math`` and
    ``_yuv420_pack_math`` compute them before they round (color.py:523-530,
    577-587)."""
    if intent is None:
        y = jnp.power(x, 0.45) * 255.0
    else:
        s = jnp.where(x <= 0.0031308, x * 12.92,
                      1.055 * jnp.power(x, 1.0 / 2.4) - 0.055)
        y = jnp.power(ref_color.quantize_f16_trunc(s),
                      jnp.float32(intent)) * 255.0
    return jnp.clip(jnp.nan_to_num(y, nan=0.0), 0.0, 255.0)


@pytest.mark.parametrize('intent', [None, 1.25, 0.8])
def test_level_table_matches_jax_on_every_f16(intent):
    table = color._levels_table(intent, 'cpu')
    assert table.dtype == torch.float32 and table.shape == (65536,)
    want = np.asarray(jax.jit(lambda d: _ref_levels(d, intent))(
        jnp.asarray(ALL_F16)))
    np.testing.assert_array_equal(table.numpy().view(np.uint32),
                                  want.view(np.uint32))
    x16 = torch.from_numpy(ALL_F16.astype(np.float16)).view(1, 4, 128, 128)
    levels = color._display_levels(x16, intent)
    np.testing.assert_array_equal(levels.numpy().ravel(), want)
    # what the conversions round from the levels: u8-equal
    if intent is not None:
        ref_u8 = np.asarray(jax.jit(lambda d: ref_color._display_u8_math(
            d, intent, (0, 1, 2, 3)))(jnp.asarray(x16.float().numpy())))
        np.testing.assert_array_equal(
            color.display_u8(x16, intent, (0, 1, 2, 3)).numpy(), ref_u8)
    ref_yuv = np.asarray(jax.jit(lambda d: ref_color._yuv420_pack_math(
        d, intent))(jnp.asarray(x16.float().numpy())))
    np.testing.assert_array_equal(color.yuv420_pack(x16, intent).numpy(),
                                  ref_yuv)


def test_level_tables_are_kept_per_intent_and_device_with_a_bound():
    color._levels_table.cache_clear()
    first = color._levels_table(1.25, 'cpu')
    assert color._levels_table(1.25, 'cpu') is first
    assert color._display_levels(torch.zeros(1, 4, 2, 2).half(), 1.25) \
        .shape == (1, 4, 2, 2)
    assert color._levels_table.cache_info().currsize == 1     # 1.25 is 1.25
    bound = color._levels_table.cache_info().maxsize
    assert bound is not None and bound <= 16
    for k in range(bound + 2):
        color._levels_table(1.0 + k / 64, 'cpu')
    assert color._levels_table.cache_info().currsize == bound



def test_yuv420_post_on_the_cpu_takes_the_plain_ops(monkeypatch):
    """A CPU tensor takes the plain ops of the yuv420 post: no kernel
    library is loaded and no launch is counted."""
    from canvas_tpu_torch.ops import _build, cuda_ops

    def no_library():
        raise AssertionError('the CPU post loaded the kernel library')

    monkeypatch.setattr(_build, 'library', no_library)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -0.1, 1.3, (2, 4, 9, 13)).astype(np.float16))
    before = (cuda_ops.yuv420_post.launches,
              cuda_ops.yuv420_post.launches_vector,
              cuda_ops.yuv420_post.launches_scalar)
    got = color.POSTS['yuv420'](x)
    assert torch.equal(got, color.yuv420_pack_studio_plain(x))
    assert (cuda_ops.yuv420_post.launches,
            cuda_ops.yuv420_post.launches_vector,
            cuda_ops.yuv420_post.launches_scalar) == before
    with pytest.raises(ValueError, match='unsupported device'):
        cuda_ops.yuv420_post(x, color._gamma45_u8_table('cpu'))


def test_yuv420_post_arguments_match_its_signature():
    """The wrapper's argument list for ``canvas_yuv420_post`` has the
    count and kinds of its ctypes signature, each value accepted by its
    ctypes type (a wrong list only shows on the card)."""
    import ctypes

    from canvas_tpu_torch.ops import _build, cuda_ops
    x = torch.zeros((2, 4, 6, 8), dtype=torch.float16)
    table = color._gamma45_u8_table('cpu')
    out = torch.empty((2, 6 * 8 + 2 * 3 * 4), dtype=torch.uint8)
    args = cuda_ops._yuv420_args(x, table, out, True, 0, 12345)
    argtypes = _build._SIGNATURES['canvas_yuv420_post']
    assert len(args) == len(argtypes)
    for arg, argtype in zip(args, argtypes):
        assert isinstance(arg, int)
        argtype(arg)
    assert [a for a, t in zip(args, argtypes) if t is ctypes.c_void_p] == [
        x.data_ptr(), table.data_ptr(), out.data_ptr(), 12345]
    assert args[3:7] == (2, 6, 8, 1)


def test_gamma45_u8_table_holds_every_f16_level():
    """The kernel's level table is ``_gamma45_floor`` of every f16 bit
    pattern, as u8 without loss: whole levels 0-255, NaN and negatives
    0, everything from 1.0 up 255."""
    table = color._gamma45_u8_table('cpu')
    x = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.float16))
    levels = color._gamma45_floor(x)
    assert table.dtype == torch.uint8 and table.shape == (65536,)
    assert torch.equal(table.float(), levels)
    assert int(table[0x7E00]) == 0 and int(table[0xBC00]) == 0
    assert int(table[0x3C00]) == 255 and int(table[0x7C00]) == 255
