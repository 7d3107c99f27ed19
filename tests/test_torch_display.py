"""The port's display path (canvas_tpu_torch.render.RenderPlanner
.render_display, its viewport matrices and transports, and the display
conversions of canvas_tpu_torch.ops.color) against the JAX package's, on
the CPU.

Each package plans its own headline timeline (bench.build_timeline and
timelines.build_timeline; the mixed-content one from
benchmarks._mixed_timeline and timelines.mixed_timeline), the port on
the plain versions of its kernels, the JAX package on CPU JAX.

Tolerances:

- The display conversions, over every f16 bit pattern and on seeded
  odd-sized frames: u8-equal to ``_display_u8_math``,
  ``_yuv420_pack_math`` and ``_u8_math``, tolerance 0. The levels come
  from a table built with libm's ``powf``, which is XLA's ``pow`` on the
  CPU; ``torch.pow`` lands an ulp or two away on ~2% of inputs, which a
  2x2 chroma mean could carry across a rounding step
  (test_torch_pow_differs_from_xla_by_an_ulp names that gap, the reason
  for the table). On larger seeded frames the yuv420 pack may still
  differ by 1 on at most 1e-5 of values
  (test_yuv420_pack_residual_on_larger_frames says why).
- ``render_display`` on the headline: u8-equal to the JAX package's for
  every transport, intent, channel order and viewport tested.
- ``render_display`` on a 1080p frame of the mixed timeline: the f16
  frames themselves differ on ~1e-4 of values, by one ulp (the DV
  scalers' f32 contractions sum in torch's order, not XLA's;
  test_torch_mixed.py), and that is the only gap: at full size a u8
  value may differ, by 1, only where its f16 value differs; through a
  viewport or the yuv420 pack (which spread a value over its filter
  taps or its 2x2 chroma block) at most 3 on at most 1e-4 of values.
"""

import gc
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bench
import benchmarks
from canvas_tpu import render as ref_render
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.ops import color as ref_color
from canvas_tpu.ops import scale as ref_scale
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.framefuncs import LerpFunc
from canvas_tpu_torch.ops import color
from canvas_tpu_torch.signal import Signal
from canvas_tpu_torch.sources import SolidColorVideoSource, VideoWorkspace

ALL_F16 = np.arange(65536, dtype=np.uint16).view(np.float16)
WINDOW = (0, 0, 255, 143)
FRAME = 130          # both scalers and their regions overhang the window
BGRA, RGBA = (2, 1, 0, 3), (0, 1, 2, 3)


@pytest.fixture(scope='module')
def planners():
    """(the JAX package's planner, the port's) of the headline at
    256x144; each keeps its cached display segment across the tests."""
    ref = ref_render.RenderPlanner(bench.build_timeline(1024),
                                   ref_box2i(*WINDOW))
    got = port.RenderPlanner(timelines.build_timeline(1024), box2i(*WINDOW),
                             device='cpu')
    return ref, got


@pytest.mark.parametrize('display_size', [None, (33, 21), (128, 72)])
@pytest.mark.parametrize('order', [BGRA, RGBA])
@pytest.mark.parametrize('intent', [None, 1.25])
@pytest.mark.parametrize('transport', ['u8', 'rgb24', 'yuv420'])
def test_render_display_matches_jax(planners, transport, intent, order,
                                    display_size):
    ref, planner = planners
    kw = dict(order=order, intent=intent, display_size=display_size,
              transport=transport)
    want = ref.render_display(FRAME, **kw)
    got = planner.render_display(FRAME, **kw)
    w, h = display_size or (WINDOW[2] + 1, WINDOW[3] + 1)
    assert got.dtype == np.uint8 and got.shape == (h, w, 4) == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope='module')
def mixed_1080p():
    window = (0, 0, 1919, 1079)
    ref = ref_render.RenderPlanner(benchmarks._mixed_timeline(256),
                                   ref_box2i(*window))
    got = port.RenderPlanner(timelines.mixed_timeline(256), box2i(*window),
                             device='cpu')
    return ref, got


@pytest.mark.parametrize('transport, intent, display_size', [
    ('u8', None, None), ('rgb24', 1.25, None), ('rgb24', 1.25, (960, 540)),
    ('yuv420', 1.25, None)])
def test_render_display_mixed_1080p_matches_jax(mixed_1080p, transport,
                                                intent, display_size):
    """Frame 70 of the mixed timeline: three DV regions through
    region_over, animated scalers."""
    ref, planner = mixed_1080p
    kw = dict(intent=intent, display_size=display_size,
              transport=transport)
    want = ref.render_display(70, **kw).astype(np.int32)
    got = planner.render_display(70, **kw).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if transport != 'yuv420' and display_size is None:
        f16_differs = (_display_f16(planner, 70)
                       != _ref_display_f16(ref, 70)).any(axis=0)
        assert diff.max() <= 1
        assert not (diff.any(axis=2) & ~f16_differs).any()
    else:
        assert diff.max() <= 3 and np.mean(diff != 0) <= 1e-4


def _display_f16(planner, i):
    """The port's f16 frame *i* from its cached display segment."""
    seg = planner._display_seg
    pos = i - seg['lo']
    params = [{k: (port._frame_slice(v, port._BATCH_AXIS.get(op, 0), pos)
                   if k in port._frame_params(op) else v)
               for k, v in p.items()}
              for p, op in zip(seg['params'], seg['ops'])]
    return port.run(seg['sig1'], params, planner.device)[0].numpy()


def _ref_display_f16(ref, i):
    """The JAX package's f16 frame *i* from its cached display segment."""
    seg = ref._display_seg
    pos = i - seg['lo']
    params = [{k: (np.take(np.asarray(v), [pos],
                           axis=ref_render._BATCH_AXIS.get(op, 0))
                   if k in ref_render._frame_params(op) else v)
               for k, v in p.items()}
              for p, op in zip(seg['params'], seg['ops'])]
    return np.asarray(jax.jit(ref_render._make_run(seg['sig1'], None, jnp,
                                                   jax))(params))[0]


def _all_f16_frames():
    return ALL_F16.reshape(1, 4, 128, 128)


@pytest.mark.parametrize('order', [BGRA, RGBA, (2, 1, 0), (0, 1, 2)])
@pytest.mark.parametrize('intent', [1.25, 1.0, 0.8])
def test_display_u8_matches_jax_on_every_f16(intent, order):
    x = _all_f16_frames()
    want = np.asarray(jax.jit(
        lambda d: ref_color._display_u8_math(d, intent, order))(
            jnp.asarray(x.astype(np.float32))))
    got = color.display_u8(torch.from_numpy(x), intent, order).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('intent', [None, 1.25, 0.8])
@pytest.mark.parametrize('shape', [(1, 4, 128, 128), (3, 4, 21, 33),
                                   (2, 4, 7, 5)])
def test_yuv420_pack_matches_jax(intent, shape):
    """Every f16 bit pattern, and seeded frames of odd sizes (the chroma
    edge-replicates the last row and column)."""
    if shape[2] == 128:
        x = _all_f16_frames()
    else:
        x = np.random.default_rng(shape[2]).uniform(
            -0.1, 1.3, shape).astype(np.float16)
    want = np.asarray(jax.jit(
        lambda d: ref_color._yuv420_pack_math(d, intent))(
            jnp.asarray(x.astype(np.float32))))
    got = color.yuv420_pack(torch.from_numpy(x), intent).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed, shape', [(2, (1, 4, 540, 960)),
                                         (3, (4, 4, 135, 241))])
def test_yuv420_pack_residual_on_larger_frames(seed, shape):
    """On larger seeded frames the pack stays within 1 of the JAX
    package's on at most 1e-5 of values: its CPU code fuses some
    multiply-adds, and ``color.yuv420_pack`` reproduces the pattern of
    the chroma and of the written Y, not every choice its compiler
    makes (measured here: 0 and 1 value of 195,964)."""
    x = np.random.default_rng(seed).uniform(-0.1, 1.3, shape).astype(
        np.float16)
    want = np.asarray(jax.jit(
        lambda d: ref_color._yuv420_pack_math(d, None))(
            jnp.asarray(x.astype(np.float32))))
    got = color.yuv420_pack(torch.from_numpy(x), None).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff != 0) <= 1e-5


def test_torch_pow_differs_from_xla_by_an_ulp():
    """Why the display levels are a table built with libm's ``powf``
    and not ``torch.pow``: XLA on the CPU computes ``pow`` with ``powf``,
    bit for bit, and ``torch.pow`` lands one f32 ulp away on ~2% of the
    positive f16 values (two on a few of the smallest). A mean of
    several such levels, the yuv420 chroma, can round the other way."""
    x = ALL_F16.astype(np.float32)
    x = x[np.isfinite(x) & (x > 0)]
    libm_powf = ref_color._libm_powf()
    for e in (0.45, 1.0 / 2.4, 1.25):
        xla = np.asarray(jax.jit(lambda d: jnp.power(d, jnp.float32(e)))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(xla, libm_powf(x, float(np.float32(e))))
        ours = torch.pow(torch.from_numpy(x), e).numpy()
        ulps = np.abs(ours.view(np.int32) - xla.view(np.int32))
        assert ulps.max() <= 2 and 0 < np.mean(ulps != 0) <= 0.05


@pytest.mark.parametrize('order', [BGRA, RGBA, (2, 1, 0), (0, 1, 2)])
def test_u8_interleaved_matches_jax_on_every_f16(order):
    x = _all_f16_frames()
    want = np.asarray(jax.jit(lambda d: ref_color._u8_math(d, order))(
        jnp.asarray(x.astype(np.float32))))
    got = color.u8_interleaved(torch.from_numpy(x), order).numpy()
    assert got.shape == want.shape == (1, 128, 128 * len(order))
    np.testing.assert_array_equal(got, want)


def test_u8_interleaved_three_channels():
    """rgb24's three channels give W*3 bytes a row, in the order asked
    (the reshape once assumed four channels and raised)."""
    x = np.random.default_rng(7).uniform(0, 1, (2, 4, 5, 6)).astype(
        np.float16)
    four = color.u8_interleaved(torch.from_numpy(x), BGRA).numpy()
    three = color.u8_interleaved(torch.from_numpy(x), (2, 1, 0)).numpy()
    assert three.shape == (2, 5, 18)
    np.testing.assert_array_equal(three.reshape(2, 5, 6, 3),
                                  four.reshape(2, 5, 6, 4)[..., :3])


def test_host_display_helpers_match_jax():
    rng = np.random.default_rng(11)
    lin = rng.uniform(-0.1, 1.2, (4, 9, 7)).astype(np.float16)
    for intent in (1.25, 1.0):
        np.testing.assert_array_equal(color.display_ramp_u8(intent),
                                      ref_color.display_ramp_u8(intent))
        np.testing.assert_array_equal(color.apply_display_u8(lin, intent),
                                      ref_color.apply_display_u8(lin,
                                                                 intent))
    flat3 = rng.integers(0, 256, (2, 5, 18)).astype(np.uint8)
    for order in (BGRA, RGBA, (3, 0, 1, 2)):
        np.testing.assert_array_equal(color.rgb24_unpack(flat3, order),
                                      ref_color.rgb24_unpack(flat3, order))
    for h, w in ((6, 8), (5, 7)):
        n = h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
        flat = rng.integers(0, 256, n).astype(np.uint8)
        for order in (BGRA, RGBA):
            np.testing.assert_array_equal(
                color.yuv420_unpack(flat, h, w, order),
                ref_color.yuv420_unpack(flat, h, w, order))


@pytest.mark.parametrize('window_h, window_w, display_size', [
    (144, 256, (33, 21)), (144, 256, (128, 72)), (1080, 1920, (960, 540)),
    (64, 64, (32, 16)), (480, 720, (655, 480))])
def test_display_matrices_host_match_jax(window_h, window_w, display_size):
    got = port.display_matrices_host(window_h, window_w, display_size)
    want = ref_render.display_matrices_host(window_h, window_w,
                                            display_size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert not g.flags.writeable
    assert port.display_matrices_host(window_h, window_w,
                                      display_size)[0] is got[0]


def test_display_matrices_lru_on_the_planner():
    planner = port.RenderPlanner(SolidColorVideoSource((1, 0, 0, 1)),
                                 box2i(0, 0, 63, 47), device='cpu')
    assert planner._display_matrices(None) is None
    first = planner._display_matrices((32, 24))
    for w in range(1, port._DISPLAY_MATS_KEPT + 1):
        planner._display_matrices((w, 8))
    assert len(planner._display_mats) == port._DISPLAY_MATS_KEPT
    assert (32, 24) not in planner._display_mats     # least recent, dropped
    again = planner._display_matrices((32, 24))
    assert again is not first and torch.equal(again[0], first[0])
    planner.close()
    assert len(planner._display_mats) == 0


def test_render_display_rejects_unknown_transport(planners):
    with pytest.raises(ValueError, match='transport'):
        planners[1].render_display(0, transport='rgba64')


# --- ports of tests/test_render.py's render_display tests ----------------

def test_render_display_scrub_cache():
    """Consecutive render_display calls slice one cached segment plan
    (its params on the device once); results equal per-frame renders,
    and edits invalidate the cache (test_render.py:1019-1046)."""
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 128)), x=0, length=128, z=0)
    window = box2i(0, 0, 31, 31)
    planner = port.RenderPlanner(ws, window, device='cpu')

    frames = [planner.render_display(i) for i in (5, 6, 7, 70, 3)]
    for idx, i in enumerate((5, 6, 7, 70, 3)):
        f16 = planner.render(i, i + 1)[0].astype(np.float32)
        y = np.power(np.clip(f16, 0, None), 0.45) * 255.0
        want = np.floor(np.clip(np.nan_to_num(y), 0, 255)).astype(np.uint8)
        np.testing.assert_array_equal(frames[idx][..., 2], want[0],
                                      err_msg='frame %d' % i)

    seg = planner._display_seg
    assert seg['lo'] <= 3 < seg['hi']
    assert all(isinstance(v, (torch.Tensor, int))
               for p in seg['params'] for v in p.values())

    # a ranged update outside the segment keeps it; one inside drops it
    planner.invalidate_display_cache(seg['hi'] + 10, seg['hi'] + 20)
    assert planner._display_seg is seg
    planner.invalidate_display_cache(seg['lo'], seg['lo'])
    assert planner._display_seg is None
    planner.render_display(3)
    planner.invalidate_display_cache()
    assert planner._display_seg is None
    bgra = planner.render_display(5)
    np.testing.assert_array_equal(bgra, frames[0])


def test_planner_close_disconnects_frames_updated():
    """render_display subscribes to the source's frames_updated; close()
    disconnects eagerly, and the port's Signal holds the planner only
    weakly, so a dropped planner never leaks (test_render.py:1107-1133)."""
    src = SolidColorVideoSource((0.5, 0.25, 0.125, 1.0))
    src.frames_updated = Signal()
    window = box2i(0, 0, 31, 15)

    planner = port.RenderPlanner(src, window, device='cpu')
    planner.render_display(0)
    assert len(src.frames_updated) == 1
    src.frames_updated(0, 3)
    assert planner._display_seg is None
    planner.close()
    assert len(src.frames_updated) == 0

    planner2 = port.RenderPlanner(src, window, device='cpu')
    planner2.render_display(0)
    assert len(src.frames_updated) == 1
    del planner2
    gc.collect()
    src.frames_updated.fire()
    assert len(src.frames_updated) == 0


def _two_layer_workspace():
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
           x=0, length=8, z=0)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((1.0, 0.2, 0.1, 0.8), (0.0, 0.9, 0.5, 0.3), 8),
        window=box2i(4, 4, 40, 40)), x=0, length=8, z=1)
    return ws


def test_render_display_viewport_size():
    """display_size: linear-light downscale on the device before the u8
    conversion (test_render.py:1136-1171): within 1 of a host downscale
    of the f16 frame with the same triangle matrices."""
    planner = port.RenderPlanner(_two_layer_workspace(), box2i(0, 0, 63, 63),
                                 device='cpu')
    bgra = planner.render_display(3, display_size=(32, 16))
    assert bgra.shape == (16, 32, 4) and bgra.dtype == np.uint8

    f16 = planner.render(3, 4)[0].astype(np.float32)
    Dy, _ = ref_scale.axis_matrix(16 / 64, 0, 15, 0, 63, 0.0, 0.0)
    Dx, _ = ref_scale.axis_matrix(32 / 64, 0, 31, 0, 63, 0.0, 0.0)
    small = np.einsum('yh,chw->cyw', Dy, f16)
    small = np.einsum('xw,cyw->cyx', Dx, small).astype(np.float16)
    y = np.power(np.clip(small.astype(np.float32), 0, None), 0.45) * 255.0
    want = np.floor(np.clip(np.nan_to_num(y), 0.0, 255.0)).astype(np.uint8)
    for c_dst, c_src in enumerate(BGRA):
        diff = np.abs(bgra[..., c_dst].astype(int) -
                      want[c_src].astype(int))
        assert diff.max() <= 1, 'channel %d' % c_dst

    assert planner.render_display(3).shape == (64, 64, 4)


@pytest.mark.parametrize('intent, display_size', list(itertools.product(
    [None, 1.25], [None, (32, 32)])))
def test_render_display_rgb24_transport(intent, display_size):
    """rgb24 matches the u8 transport's color channels exactly, alpha
    padded to 255 (test_render.py:2236-2260)."""
    planner = port.RenderPlanner(_two_layer_workspace(), box2i(0, 0, 63, 63),
                                 device='cpu')
    kw = dict(intent=intent, display_size=display_size)
    full = planner.render_display(3, **kw)
    rgb = planner.render_display(3, transport='rgb24', **kw)
    assert rgb.shape == full.shape and rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb[..., :3], full[..., :3])
    assert (rgb[..., 3] == 255).all()


def test_render_display_quality_9_keeps_acc16(planners):
    """set_quality drops the display segment: the next pull plans the
    quality-9 (acc16) segment, which matches the JAX package's."""
    ref = ref_render.RenderPlanner(bench.build_timeline(1024),
                                   ref_box2i(*WINDOW), quality=9)
    planner = port.RenderPlanner(timelines.build_timeline(1024),
                                 box2i(*WINDOW), device='cpu')
    planner.render_display(FRAME)
    planner.set_quality(9)
    assert planner._display_seg is None
    got = planner.render_display(FRAME, intent=1.25)
    assert 'acc16' in repr(planner._display_seg['sig1'])
    np.testing.assert_array_equal(got, ref.render_display(FRAME,
                                                          intent=1.25))
