"""The port's eager pull (``VideoSource.get_frame_f16/f32``) on the CPU:
the thread-local backend dispatch of ``canvas_tpu_torch.backend`` and
the torch arms of the pixel ops, against the port's NumPy arms and the
JAX package's JAX arms (CPU JAX).

- The JAX suite's backend-parametrised source tests
  (``tests/test_video_sources.py``, its ``any_backend`` cases over
  solids, mix, gain/offset, sequence, workspace and transfer) run on the
  port over its NumPy arm and its torch arm on the CPU, through the
  ``port_mode`` fixture defined here.
- Each torch arm, run under ``force_backend('torch', device='cpu')`` on
  seeded inputs (numpy, ``SEED``), against the port's NumPy arm and the
  JAX arm (``canvas_tpu.backend.force_backend('jax')``):
  - bit-equal: fills, places, f16 <-> f32 conversions, and the f16 table
    gathers over every one of the 65,536 f16 values;
  - at most 1e-6 absolute on f32: ``cross``, ``over``, ``attenuate``,
    ``over_stack`` and gain/offset. The torch arm is bit-equal to the
    NumPy arm; against the JAX arm only the rounding of XLA's CPU code,
    which fuses a multiply into the add it feeds, departs;
  - within 2 f32 ulps: the f32 transfer curves (``torch.pow`` against
    NumPy's ``power`` and against libm's ``powf`` in XLA);
  - at most 1e-5 absolute: ``scale_bilinear`` and ``color_matrix``,
    einsums at full f32;
  - reconstructions within 1 f16 ulp on at least 99.99% of values, any
    value further apart read from two adjacent inputs of the
    rec709 -> linear table (up to 3 ulps, as the NumPy and JAX arms are
    apart); subsamples u8-equal but for one step on at most 1e-5 of
    values (as the NumPy and JAX arms); ``lanczos_weights`` bit-equal.
- Whole frames at 320x180 (57,600 pixels, so ``'auto'`` takes the torch
  arm): the headline (frames 0, 130, 1000) and config7 (frames 0, 70)
  against the JAX package's ``'auto'`` pull and the port's NumPy arm:
  within 1 f16 ulp on at least 99.9% of values, and inside the render
  gates (2e-3 for the headline; 1e-2 with 99% bit-equal for config7).
- The readers of a pulled frame accept a torch-arm frame: ``write_video``'s
  eager arm (its u8 encoder input equal), the Matroska audio writer,
  thumbnails, and the frame's ``pixel``, ``to_numpy``, ``to_argb_string``
  and indexing, each equal to the NumPy arm's.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import benchmarks
from canvas_tpu import backend as ref_backend
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.ops import chroma as ref_chroma
from canvas_tpu.ops import color as ref_color
from canvas_tpu.ops import mix as ref_mix
from canvas_tpu.ops import scale as ref_scale
from canvas_tpu.ops import window as ref_window
from canvas_tpu_torch import backend, process, render, timelines
from canvas_tpu_torch.basetypes import box2i, rgba
from canvas_tpu_torch.ops import chroma, color, mix, scale, window

SEED = 20261017

#: The port's modes the source tests run under: (mode, eager device).
MODES = {'numpy': ('numpy', None), 'torch-cpu': ('torch', 'cpu')}

TORCH_CPU = ('torch', 'cpu')


@pytest.fixture(params=sorted(MODES))
def port_mode(request):
    """Parametrize a test over the port's NumPy arm and its torch arm on
    the CPU (the counterpart of tests/conftest.py's ``any_backend``)."""
    name, device = MODES[request.param]
    with backend.force_backend(name, device):
        yield name


def _arm(frame, mode):
    """The pulled frame's data lies where *mode* puts it."""
    if frame.current_window.empty():
        return
    if mode == 'torch':
        assert isinstance(frame.data, torch.Tensor)
        assert frame.data.device.type == 'cpu'
    else:
        assert isinstance(frame.data, np.ndarray)


def check_color(c1, c2, places=6):
    for x, y in zip(c1, c2):
        assert abs(x - y) < 10 ** -places, (c1, c2)


# --- the JAX suite's source tests over the port's two arms ------------------

class TestSolidColor:
    def test_const_color(self, port_mode):
        color_ = (1.0, 0.5, 0.333333, 0.2)
        solid = process.SolidColorVideoSource(color_)
        frame = solid.get_frame_f32(0, box2i(0, 0, 3, 3))
        _arm(frame, port_mode)

        assert frame.current_window == box2i(0, 0, 3, 3)
        check_color(frame.pixel(0, 0), color_)
        check_color(frame.pixel(3, 3), color_)

    def test_const_window(self, port_mode):
        color_ = (1.0, 0.5, 0.333333, 0.2)
        solid = process.SolidColorVideoSource(color_, box2i(0, 0, 2, 2))
        frame = solid.get_frame_f32(0, box2i(0, 0, 3, 3))

        assert frame.current_window == box2i(0, 0, 2, 2)
        check_color(frame.pixel(0, 0), color_)
        # outside the window: undefined -> None (RgbaFrameF32.c:95-107)
        assert frame.pixel(3, 3) is None

        # a frame is itself a source: re-window it
        frame2 = frame.get_frame_f32(0, box2i(-1, -1, 1, 1))
        _arm(frame2, port_mode)
        assert frame2.current_window == box2i(0, 0, 1, 1)
        check_color(frame2.pixel(0, 0), color_)
        assert frame2.pixel(-1, -1) is None

    def test_moving_color(self, port_mode):
        solid = process.SolidColorVideoSource(
            process.LerpFunc((0.5, 0.25, 2.0, 1.0), (-0.5, -0.25, -2.0, 0.0),
                             2))

        frame = solid.get_frame_f32(0, box2i(0, 0, 0, 0))
        check_color(frame.pixel(0, 0), rgba(0.5, 0.25, 2.0, 1.0))

        frame = solid.get_frame_f32(1, box2i(0, 0, 0, 0))
        check_color(frame.pixel(0, 0), rgba(0.0, 0.0, 0.0, 0.5))

        frame = solid.get_frame_f32(2, box2i(0, 0, 0, 0))
        check_color(frame.pixel(0, 0), rgba(-0.5, -0.25, -2.0, 0.0))

    def test_moving_window(self, port_mode):
        solid = process.SolidColorVideoSource(
            rgba(0.0, 0.0, 1.0, 1.0),
            process.LerpFunc((-2, -2, 2, 2), (-4, -4, 0, 6), 2))

        frame = solid.get_frame_f32(0, box2i(-5, -5, 5, 6))
        assert frame.current_window == box2i(-2, -2, 2, 2)

        frame = solid.get_frame_f32(1, box2i(-5, -5, 5, 6))
        assert frame.current_window == box2i(-3, -3, 1, 4)

        frame = solid.get_frame_f32(2, box2i(-5, -5, 5, 6))
        assert frame.current_window == box2i(-4, -4, 0, 6)

    def test_f16_path(self, port_mode):
        color_ = (0.5, 0.25, 0.125, 1.0)
        solid = process.SolidColorVideoSource(color_)
        frame = solid.get_frame_f16(3, box2i(0, 0, 1, 1))
        _arm(frame, port_mode)
        assert frame.to_numpy().dtype == np.float16
        check_color(frame.pixel(1, 1), color_, places=3)


class TestEmptySource:
    def test_empty(self, port_mode):
        src = process.EmptyVideoSource()
        frame = src.get_frame_f32(0, box2i(0, 0, 3, 3))
        assert frame.current_window.empty()
        assert np.all(frame.to_numpy() == 0)


class TestFrameRoundTrip:
    def test_f16_f32_roundtrip(self, port_mode):
        solid = process.SolidColorVideoSource((0.125, 0.25, 0.5, 1.0))
        f16 = solid.get_frame_f16(0, box2i(0, 0, 3, 3))
        # pull f32 from an f16 frame (conversion dispatch)
        f32 = f16.get_frame_f32(0, box2i(0, 0, 3, 3))
        _arm(f32, port_mode)
        assert f32.to_numpy().dtype == np.float32
        check_color(f32.pixel(2, 2), (0.125, 0.25, 0.5, 1.0))

    def test_window_shift(self, port_mode):
        solid = process.SolidColorVideoSource((1, 1, 1, 1), box2i(2, 2, 5, 5))
        frame = solid.get_frame_f32(0, box2i(0, 0, 7, 7))
        shifted = frame.get_frame_f32(0, box2i(4, 4, 9, 9))
        assert shifted.current_window == box2i(4, 4, 5, 5)
        check_color(shifted.pixel(5, 5), (1, 1, 1, 1))
        assert shifted.pixel(6, 6) is None


class TestPassThrough:
    def test_offset(self, port_mode):
        solid = process.SolidColorVideoSource(
            process.LerpFunc((0, 0, 0, 1), (100, 0, 0, 1), 100))
        filt = process.VideoPassThroughFilter(solid, offset=10)
        frame = filt.get_frame_f32(0, box2i(0, 0, 0, 0))
        check_color(frame.pixel(0, 0), (10, 0, 0, 1))

    def test_start_end(self, port_mode):
        solid = process.SolidColorVideoSource((1, 0, 0, 1))
        filt = process.VideoPassThroughFilter(solid, start_frame=5,
                                              end_frame=10)
        assert filt.get_frame_f32(4, box2i(0, 0, 0, 0)).current_window.empty()
        assert not filt.get_frame_f32(
            5, box2i(0, 0, 0, 0)).current_window.empty()
        assert not filt.get_frame_f32(
            9, box2i(0, 0, 0, 0)).current_window.empty()
        assert filt.get_frame_f32(10,
                                  box2i(0, 0, 0, 0)).current_window.empty()


class TestMixFilter:
    def test_crossfade_midpoint(self, port_mode):
        a = process.SolidColorVideoSource((1.0, 0.0, 0.0, 1.0))
        b = process.SolidColorVideoSource((0.0, 1.0, 0.0, 1.0))
        mix_ = process.VideoMixFilter(a, b, process.LerpFunc((0,), (1,), 10))

        f = mix_.get_frame_f32(0, box2i(0, 0, 0, 0))
        check_color(f.pixel(0, 0), (1, 0, 0, 1))

        f = mix_.get_frame_f32(5, box2i(0, 0, 0, 0))
        _arm(f, port_mode)
        check_color(f.pixel(0, 0), (0.5, 0.5, 0, 1))

        f = mix_.get_frame_f32(10, box2i(0, 0, 0, 0))
        check_color(f.pixel(0, 0), (0, 1, 0, 1))

    def test_crossfade_alpha_weighting(self, port_mode):
        # rgb is weighted by per-input alpha, not just mix
        a = process.SolidColorVideoSource((1.0, 0.0, 0.0, 1.0))
        b = process.SolidColorVideoSource((0.0, 1.0, 0.0, 0.0))
        mix_ = process.VideoMixFilter(a, b, 0.5)
        f = mix_.get_frame_f32(0, box2i(0, 0, 0, 0))
        # alpha_a = 0.5, alpha_b = 0: rgb stays a's, alpha halves
        check_color(f.pixel(0, 0), (1.0, 0.0, 0.0, 0.5))

    def test_one_side_empty(self, port_mode):
        a = process.SolidColorVideoSource((1.0, 0.0, 0.0, 1.0))
        b = process.EmptyVideoSource()
        mix_ = process.VideoMixFilter(a, b, 0.25)
        f = mix_.get_frame_f32(0, box2i(0, 0, 0, 0))
        # copy a with alpha * (1 - mix_b) (video_mix.c:118-121); b's
        # frame stays the NumPy blank, which the torch arm takes in
        _arm(f, port_mode)
        check_color(f.pixel(0, 0), (1.0, 0.0, 0.0, 0.75))

    def test_windows_union(self, port_mode):
        a = process.SolidColorVideoSource((1, 0, 0, 1), box2i(0, 0, 1, 1))
        b = process.SolidColorVideoSource((0, 1, 0, 1), box2i(2, 2, 3, 3))
        mix_ = process.VideoMixFilter(a, b, 0.5)
        f = mix_.get_frame_f32(0, box2i(0, 0, 4, 4))
        assert f.current_window == box2i(0, 0, 3, 3)
        check_color(f.pixel(0, 0), (1, 0, 0, 0.5))
        check_color(f.pixel(3, 3), (0, 1, 0, 0.5))
        assert f.pixel(4, 4) is None


class TestGainOffset:
    def test_gain_offset(self, port_mode):
        src = process.SolidColorVideoSource((0.5, 0.25, 0.0, 0.8))
        filt = process.VideoGainOffsetFilter(src, gain=2.0, offset=0.1)
        f = filt.get_frame_f32(0, box2i(0, 0, 0, 0))
        _arm(f, port_mode)
        # rgb * gain + offset; alpha unchanged (video_filter.c:36-39)
        check_color(f.pixel(0, 0), (1.1, 0.6, 0.1, 0.8))

    def test_offset_respects_window(self, port_mode):
        src = process.SolidColorVideoSource((0.5, 0.5, 0.5, 1.0),
                                            box2i(0, 0, 0, 0))
        filt = process.VideoGainOffsetFilter(src, gain=1.0, offset=0.25)
        f = filt.get_frame_f32(0, box2i(0, 0, 1, 1))
        check_color(f.pixel(0, 0), (0.75, 0.75, 0.75, 1.0))
        assert f.pixel(1, 1) is None


class TestVideoSequence:
    def make(self):
        red = process.SolidColorVideoSource(
            process.LerpFunc((0, 0, 0, 1), (100, 0, 0, 1), 100))
        green = process.SolidColorVideoSource(
            process.LerpFunc((0, 0, 0, 1), (0, 100, 0, 1), 100))
        return red, green

    def test_lookup(self, port_mode):
        red, green = self.make()
        seq = process.VideoSequence()
        seq.append((red, 0, 5))
        seq.append((green, 10, 5))

        assert len(seq) == 2
        assert seq.get_start_frame(0) == 0
        assert seq.get_start_frame(1) == 5

        f = seq.get_frame_f32(2, box2i(0, 0, 0, 0))
        check_color(f.pixel(0, 0), (2, 0, 0, 1))

        # frame 7 -> second clip, local frame 7-5+10 = 12
        f = seq.get_frame_f32(7, box2i(0, 0, 0, 0))
        check_color(f.pixel(0, 0), (0, 12, 0, 1))

        # past the end / before the start: empty
        assert seq.get_frame_f32(10, box2i(0, 0, 0, 0)).current_window.empty()
        assert seq.get_frame_f32(-1, box2i(0, 0, 0, 0)).current_window.empty()

    def test_edit(self, port_mode):
        red, green = self.make()
        seq = process.VideoSequence()
        seq.append((red, 0, 5))
        seq.append((green, 0, 5))
        seq.insert(1, (red, 50, 3))

        assert seq.get_start_frame(1) == 5
        assert seq.get_start_frame(2) == 8
        assert seq[1] == (red, 50, 3)

        seq[1] = (red, 50, 10)
        assert seq.get_start_frame(2) == 15

        del seq[1]
        assert seq.get_start_frame(1) == 5
        f = seq.get_frame_f32(6, box2i(0, 0, 0, 0))
        check_color(f.pixel(0, 0), (0, 1, 0, 1))

    def test_zero_length(self, port_mode):
        red, green = self.make()
        seq = process.VideoSequence()
        seq.append((red, 0, 0))
        seq.append((green, 20, 5))
        f = seq.get_frame_f32(0, box2i(0, 0, 0, 0))
        check_color(f.pixel(0, 0), (0, 20, 0, 1))
        with pytest.raises(ValueError):
            seq.append((red, 0, -1))


def test_transfer_filter_none_source_plans_empty(port_mode):
    """VideoColorTransferFilter(None, ...) renders empty on the eager
    path; planning the same graph must agree instead of raising."""
    ws = process.VideoWorkspace()
    ws.add(source=process.VideoColorTransferFilter(None, 'linear_to_srgb'),
           x=0, length=8, z=0)
    assert ws.get_frame_f16(0, box2i(0, 0, 31, 23)).current_window.empty()
    out = np.asarray(render.render_frames(ws, box2i(0, 0, 31, 23), 0, 4,
                                          device='cpu'))
    assert (out == 0).all()


def test_workspace_composites_on_either_arm(port_mode):
    """A workspace over both arms: a bottom item, a transparent-edged
    card over it, and a transfer filter on top (f16 LUT gather)."""
    ws = process.VideoWorkspace()
    ws.add(source=process.SolidColorVideoSource((0.2, 0.3, 0.4, 1.0)),
           x=0, length=4, z=0)
    ws.add(source=process.SolidColorVideoSource((0.9, 0.1, 0.1, 0.5),
                                                box2i(1, 1, 2, 2)),
           x=0, length=4, z=1)
    top = process.VideoColorTransferFilter(
        process.SolidColorVideoSource((0.5, 0.5, 0.5, 0.25),
                                      box2i(3, 0, 3, 3)), 'linear_to_srgb')
    ws.add(source=top, x=0, length=4, z=2)
    f = ws.get_frame_f32(1, box2i(0, 0, 3, 3))
    _arm(f, port_mode)
    # over at full opacity: alpha_a = 1 * (1 - 0.5) = 0.5
    check_color(f.pixel(1, 1), (0.55, 0.2, 0.25, 1.0), places=5)
    check_color(f.pixel(0, 0), (0.2, 0.3, 0.4, 1.0))
    srgb = 1.055 * 0.5 ** (1 / 2.4) - 0.055
    alpha = 1.055 * 0.25 ** (1 / 2.4) - 0.055
    got = f.pixel(3, 0)
    assert abs(got.a - (alpha + 1.0 * (1 - alpha))) < 2e-3, got
    assert abs(got.r - (srgb * alpha + 0.2 * (1 - alpha)) / got.a) < 2e-3


# --- each torch arm against the NumPy arm and the JAX arm -------------------

def _rng(k=0):
    return np.random.default_rng(SEED + k)


def _bits_equal(a, b):
    a, b = backend.asnumpy(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                        a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _torch(x):
    return torch.from_numpy(np.array(x))


FILLS = {
    'inside': (-3, 2, 40, 20),
    'overhang': (-50, -40, 10, 200),
    'empty': (10, 10, 9, 9),
    'outside': (500, 500, 600, 600),
}


@pytest.mark.parametrize('dtype', ['float16', 'float32'])
@pytest.mark.parametrize('fill', sorted(FILLS))
def test_fill_solid_arms_bit_equal(fill, dtype):
    full = (-8, -4, 71, 35)
    color_ = tuple(float(v) for v in
                   _rng(1).uniform(-0.5, 2.0, 4).astype(np.float32))
    with backend.force_backend(*TORCH_CPU):
        got = window.fill_solid(box2i(*full), np.dtype(dtype), color_,
                                box2i(*FILLS[fill]))
    assert isinstance(got, torch.Tensor)
    with backend.force_backend('numpy'):
        host = window.fill_solid(box2i(*full), np.dtype(dtype), color_,
                                 box2i(*FILLS[fill]))
    want = ref_window.fill_solid(ref_box2i(*full), np.dtype(dtype), color_,
                                 ref_box2i(*FILLS[fill]), force_jax=True)
    _bits_equal(got, host)
    _bits_equal(got, want)


PLACES = {
    'shift': ((-10, 5, 49, 44), (0, 0, 63, 47), (-4, 8, 30, 40)),
    'identity': ((0, 0, 31, 23), (0, 0, 31, 23), (2, 3, 20, 22)),
    'disjoint': ((0, 0, 31, 23), (100, 100, 131, 123), (2, 3, 20, 22)),
}


@pytest.mark.parametrize('case', sorted(PLACES))
def test_place_arms_bit_equal_and_never_alias(case):
    from canvas_tpu_torch.basetypes import box2i_intersect
    src_w, dst_w, cur = (box2i(*b) for b in PLACES[case])
    data = _rng(2).uniform(0, 1, (4, src_w.height, src_w.width)).astype(
        np.float16)
    copy_box = box2i_intersect(cur, dst_w)
    t = _torch(data)
    got = window.place(t, src_w, dst_w, copy_box)
    host = window.place(data, src_w, dst_w, copy_box)
    ref_copy = ref_box2i(copy_box.min.x, copy_box.min.y, copy_box.max.x,
                         copy_box.max.y)
    want = ref_window.place(jnp.asarray(data), ref_box2i(*PLACES[case][0]),
                            ref_box2i(*PLACES[case][1]), ref_copy)
    _bits_equal(got, host)
    _bits_equal(got, want)
    got.add_(1)                          # the result never aliases src
    np.testing.assert_array_equal(t.numpy(), data)


@pytest.mark.parametrize('to', ['float16', 'float32'])
def test_convert_arms_bit_equal(to):
    frm = np.float32 if to == 'float16' else np.float16
    data = (_rng(3).standard_normal((4, 16, 24)) * 3e4).astype(frm)
    data[0, 0, :4] = (6.1e-5, -3e-8, 65519.0, 65520.0)
    got = window.convert(_torch(data), np.dtype(to))
    assert got.dtype == backend.torch_dtype(to)
    _bits_equal(got, window.convert(data, np.dtype(to)))
    _bits_equal(got, jnp.asarray(data).astype(to))


def _every_f16():
    return np.arange(65536, dtype=np.uint16).view(np.float16).reshape(
        4, 128, 128)


@pytest.mark.parametrize('name', ['rec709_to_linear_scene',
                                  'rec709_to_linear_display',
                                  'linear_to_rec709', 'linear_to_srgb',
                                  'gamma45_u8'])
def test_half_lut_gathers_every_f16_value(name):
    x = _every_f16()
    table = color.get_lut(name)
    ref_table = ref_color.get_lut(name)
    _bits_equal(table, ref_table)
    got = color.apply_half_lut(_torch(x), table)
    _bits_equal(got, color.apply_half_lut(x, table))
    _bits_equal(got, ref_color.apply_half_lut(jnp.asarray(x), ref_table))
    if name == 'gamma45_u8':
        _bits_equal(color.apply_gamma45_u8(_torch(x)),
                    ref_color.apply_gamma45_u8(jnp.asarray(x)))
    else:
        _bits_equal(getattr(color, 'transfer_' + name)(_torch(x)),
                    getattr(ref_color, 'transfer_' + name)(jnp.asarray(x)))


def _planes(k, H=24, W=40, L=None):
    """Seeded f32 (4, H, W) planes (or (L, 4, H, W)): colors in [0, 1],
    alpha in [0, 1] with a block of exact zeros."""
    shape = (4, H, W) if L is None else (L, 4, H, W)
    x = _rng(k).uniform(0.0, 1.0, shape).astype(np.float32)
    x[..., 3, :4, :6] = 0.0
    return x


MIXES = ('cross-0.3', 'cross-clamped', 'over-0.7', 'over-1', 'attenuate',
         'over_stack')


def _mix_call(lib, case, a, b, stack):
    op, _, arg = case.partition('-')
    if op == 'attenuate':
        return lib.attenuate(a, 0.375)
    if op == 'over_stack':
        return lib.over_stack(stack)
    mix_b = {'0.3': 0.3, '0.7': 0.7, '1': 1.0, 'clamped': 1.5}[arg]
    return getattr(lib, op)(a, b, mix_b)


@pytest.mark.parametrize('case', MIXES)
def test_mix_arms(case):
    """At most 1e-6 absolute on f32. The torch arm is bit-equal to the
    NumPy arm (the same op order, no fused multiply-add); against the JAX
    arm the departures are XLA's CPU multiply-add fusion in
    ``num = rgb_a * alpha_a + rgb_b * alpha_b``."""
    a, b, stack = _planes(4), _planes(5), _planes(6, L=5)
    with backend.force_backend(*TORCH_CPU):
        got = _mix_call(mix, case, a, b, stack)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    with backend.force_backend('numpy'):
        host = _mix_call(mix, case, a, b, stack)
    assert isinstance(host, np.ndarray)
    with ref_backend.force_backend('jax'):
        want = np.asarray(_mix_call(ref_mix, case, a, b, stack))
    _bits_equal(got, host)
    got = got.numpy()
    assert got.shape == want.shape == (4, 24, 40)
    assert float(np.abs(got - want).max()) <= 1e-6


def test_mix_arms_take_mixed_inputs():
    """A NumPy input beside a tensor (a blank frame beside a pulled one)
    is copied to the tensor's device; the tensor decides the arm."""
    a, b = _planes(7), _planes(8)
    with backend.force_backend('numpy'):
        got = mix.over(a, _torch(b), 1.0)
        host = mix.over(a, b, 1.0)
    assert isinstance(got, torch.Tensor)
    _bits_equal(got, host)


def test_over_stack_matches_sequential_over():
    """mix.over_stack == folding mix.over pairwise, on both arms (the
    JAX suite's test_over_stack_matches_sequential_over)."""
    layers = _planes(9, L=4, H=6, W=8)
    for mode in (TORCH_CPU, ('numpy', None)):
        with backend.force_backend(*mode):
            got = backend.asnumpy(mix.over_stack(layers))
            acc = layers[0]
            for i in range(1, layers.shape[0]):
                acc = backend.asnumpy(mix.over(acc, layers[i], 1.0))
        np.testing.assert_allclose(got, acc, atol=1e-5)


def _frame_source(lib_process, lib_box, data, full, cur):
    frames = lib_process.RgbaFrameF32
    return frames(lib_box(*full), data, lib_box(*cur))


@pytest.mark.parametrize('offset', [0.0, 0.125])
def test_gain_offset_arm(offset):
    """At most 1e-6 absolute (the JAX arm's multiply-add is fused on
    XLA's CPU); bit-equal to the NumPy arm, the zero outside the current
    window included (``_mask_outside``)."""
    from canvas_tpu import process as ref_process
    full, cur = (-5, -3, 44, 26), (0, 2, 30, 20)
    outside = np.ones((30, 50), bool)
    outside[5:24, 5:36] = False
    data = _rng(10).uniform(-0.5, 1.5, (4, 30, 50)).astype(np.float32)
    data[:, outside] = 0.0
    win = box2i(*full)
    src = process.VideoGainOffsetFilter(
        _frame_source(process, box2i, data, full, cur), gain=1.75,
        offset=offset)
    with backend.force_backend(*TORCH_CPU):
        got = src.get_frame_f32(0, win)
    assert isinstance(got.data, torch.Tensor)
    with backend.force_backend('numpy'):
        host = src.get_frame_f32(0, win)
    ref_src = ref_process.VideoGainOffsetFilter(
        _frame_source(ref_process, ref_box2i, data, full, cur), gain=1.75,
        offset=offset)
    with ref_backend.force_backend('jax'):
        want = np.asarray(ref_src.get_frame_f32(0, ref_box2i(*full)).data)
    assert got.current_window == host.current_window == box2i(*cur)
    _bits_equal(got.data, host.data)
    assert float(np.abs(got.to_numpy() - want).max()) <= 1e-6
    assert not got.to_numpy()[:, outside].any()


def _f32_ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _f16_ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float16).view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(ordered(a) - ordered(b))


#: name: (the constant the curve subtracts after its power, or 0).
CURVES = {'rec709_to_linear_scene': 0.0, 'rec709_to_linear_display': 0.0,
          'linear_to_rec709': 0.099, 'linear_to_srgb': 0.055}


@pytest.mark.parametrize('name', sorted(CURVES))
def test_transfer_curves_f32_within_two_ulps(name):
    """The power within 2 f32 ulps of the NumPy arm's (``np.power``) and
    the JAX arm's (libm's ``powf`` on XLA's CPU); everything else in the
    curve is the same f32 ops in the same order. The bound is on the
    term before the curve subtracts its constant c (0.099, 0.055 or 0):
    |got - want| <= 2 ulp(|got| + c). On the output alone the
    subtraction magnifies a power's last bit up to 4 ulps near the
    knee, as far as NumPy's and XLA's own curves are apart. The linear
    segments are bit-equal."""
    x = _rng(11).uniform(-0.05, 1.6, (4, 64, 64)).astype(np.float32)
    x[0, 0, :6] = (0.0, 0.018, 0.081, 0.0031308, 1.0, -0.0)
    fn = 'transfer_' + name
    got = getattr(color, fn)(_torch(x))
    assert got.dtype == torch.float32
    host = getattr(color, fn)(x)
    want = np.asarray(getattr(ref_color, fn)(jnp.asarray(x)))
    got = got.numpy()
    linear = x < {'rec709_to_linear_scene': 0.081,
                  'rec709_to_linear_display': 0.0,
                  'linear_to_rec709': 0.018,
                  'linear_to_srgb': 0.0031308}[name]
    for other in (host, want):
        assert not np.isnan(got).any() and not np.isnan(other).any()
        _bits_equal(got[linear], other[linear])
        term_ulp = np.spacing(np.abs(got) + np.float32(CURVES[name]))
        assert (np.abs(got - other) <= 2 * term_ulp).all()


@pytest.mark.parametrize('matrix', ['RGB_TO_XYZ_SDTV', 'XYZ_TO_SRGB'])
def test_color_matrix_arm(matrix):
    """At most 1e-5 absolute on f32 (one einsum at full f32); alpha
    passes through bit-equal."""
    data = _rng(12).uniform(-0.2, 1.3, (4, 40, 56)).astype(np.float32)
    m = getattr(color, matrix)
    got = color.color_matrix(_torch(data), m)
    host = color.color_matrix(data, m)
    want = np.asarray(ref_color.color_matrix(jnp.asarray(data),
                                             getattr(ref_color, matrix)))
    got = got.numpy()
    for other in (host, want):
        assert float(np.abs(got - other).max()) <= 1e-5
        _bits_equal(got[3], other[3])


SCALES = {
    'up': ((1.6, 1.3), (12.0, 7.0), (3.0, 2.0)),
    'down': ((0.45, 0.6), (5.0, 4.0), (1.0, -2.0)),
    'mixed': ((1.7, 0.45), (80.0, 60.0), (30.0, 20.0)),
}


@pytest.mark.parametrize('case', sorted(SCALES))
def test_scale_bilinear_arm(case):
    """At most 1e-5 absolute: two f32 einsums (TF32 off) against NumPy's
    matmuls and the JAX arm's ``precision='highest'`` einsums; the same
    current window."""
    factors, tp, sp = SCALES[case]
    src_full, src_cur = box2i(-4, -2, 75, 57), box2i(0, 0, 60, 50)
    target = box2i(-10, -6, 109, 73)
    data = _rng(13).uniform(0, 1, (4, 60, 80)).astype(np.float32)
    with backend.force_backend(*TORCH_CPU):
        got, gwin = scale.scale_bilinear(data, src_full, src_cur, target,
                                         tp, sp, factors)
    assert isinstance(got, torch.Tensor)
    with backend.force_backend('numpy'):
        host, hwin = scale.scale_bilinear(data, src_full, src_cur, target,
                                          tp, sp, factors)
    want, wwin = ref_scale.scale_bilinear(
        jnp.asarray(data), ref_box2i(-4, -2, 75, 57), ref_box2i(0, 0, 60, 50),
        ref_box2i(-10, -6, 109, 73), tp, sp, factors)
    assert tuple(gwin) == tuple(hwin) and tuple(gwin.min) == tuple(wwin.min)
    assert tuple(gwin.max) == tuple(wwin.max)
    got = got.numpy()
    assert float(np.abs(got - host).max()) <= 1e-5
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-5


@pytest.mark.parametrize('args', [(0.5, 2, 0.0), (0.25, 3, 0.375),
                                  (2.0, 2, -0.25), (1.0, 3, 0.5)])
def test_lanczos_weights_bit_equal(args):
    got, gc = scale.lanczos_weights(*args)
    want, wc = ref_scale.lanczos_weights(*args)
    assert gc == wc
    _bits_equal(got, want)


def _adjacent_entries(table, a, b):
    """Whether f16 values *a* and *b* are the table's entries at two
    adjacent finite f16 inputs (adjacent in value)."""
    bits = np.concatenate([np.arange(0xFBFF, 0x8000, -1, dtype=np.uint16),
                           np.arange(0x0000, 0x7C00, dtype=np.uint16)])
    entries = table[bits].view(np.uint16)
    at_a = np.nonzero(entries == np.float16(a).view(np.uint16))[0]
    at_b = set(np.nonzero(entries == np.float16(b).view(np.uint16))[0])
    return any(k - 1 in at_b or k + 1 in at_b for k in at_a)


def _within_f16_ulps(got, want):
    """Reconstructions: within 1 f16 ulp on >= 99.99% of values. Where two
    arms are further apart, their rgb sums (summed in another order) fell
    on either side of a step of the truncating f16 grid, so the
    rec709 -> linear table was read at two adjacent f16 inputs, whose
    entries the curve's slope sets up to 3 ulps apart: each such value
    is checked to be two adjacent entries of the table. The JAX arm and
    the NumPy arm are apart in the same way on these planes."""
    ulps = _f16_ulps(got, want)
    assert float(np.mean(ulps <= 1)) >= 0.9999, float(np.mean(ulps <= 1))
    far = ulps > 1
    if far.any():
        table = color.get_lut('rec709_to_linear_scene')
        pairs = set(zip(got[far].tolist(), want[far].tolist()))
        assert all(_adjacent_entries(table, a, b) for a, b in pairs), pairs


def _u8_planes(k, shapes):
    rng = _rng(k)
    out = []
    for i, s in enumerate(shapes):
        lo, hi = (16, 236) if i == 0 else (16, 241)
        out.append(rng.integers(lo, hi, s).astype(np.uint8))
    return tuple(out)


def test_reconstruct_dv_arm():
    """Within 1 f16 ulp on >= 99.99% of values (``_within_f16_ulps``)."""
    planes = _u8_planes(14, ((480, 720), (480, 180), (480, 180)))
    full = (-10, -20, 709, 459)
    with backend.force_backend(*TORCH_CPU):
        got, gwin = chroma.reconstruct_dv(planes, box2i(*full))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float16
    host, hwin = chroma.reconstruct_dv(planes, box2i(*full), use_torch=False)
    want, wwin = ref_chroma.reconstruct_dv(planes, ref_box2i(*full),
                                           use_jax=True)
    assert gwin == hwin and tuple(gwin.max) == tuple(wwin.max)
    got = got.numpy()
    _within_f16_ulps(got, host)
    _within_f16_ulps(got, np.asarray(want))


@pytest.mark.parametrize('geometry', ['420-rec709', '422-rec601'])
def test_reconstruct_planar_arm(geometry):
    """Within 1 f16 ulp on >= 99.99% of values (``_within_f16_ulps``)."""
    sub, matrix = geometry.split('-')
    H, W = 480, 720          # the DV frame's size: 1.38M values
    ch, cw = (H // 2, W // 2) if sub == '420' else (H, W // 2)
    planes = _u8_planes(15, ((H, W), (ch, cw), (ch, cw)))
    full = (-8, 4, 711, 483)
    with backend.force_backend(*TORCH_CPU):
        got, gwin = chroma.reconstruct_planar(planes, box2i(*full),
                                              matrix=matrix)
    assert isinstance(got, torch.Tensor)
    host, _hwin = chroma.reconstruct_planar(planes, box2i(*full),
                                            use_torch=False, matrix=matrix)
    want, _wwin = ref_chroma.reconstruct_planar(planes, ref_box2i(*full),
                                                use_jax=True, matrix=matrix)
    assert tuple(gwin.min) == (0, 4) and tuple(gwin.max) == (711, 479)
    got = got.numpy()
    _within_f16_ulps(got, host)
    _within_f16_ulps(got, np.asarray(want))


def _linear_frame(k, shape):
    return _rng(k).uniform(0.0, 1.0, shape).astype(np.float16)


def _u8_close(got, want):
    """u8 planes equal but for one step on at most 1e-5 of values: a
    value whose f32 sum (summed in another order, or through another
    ``pow``) lies at a rounding step of the u8 cast. The NumPy and JAX
    arms are apart in the same way on these frames."""
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    want = np.asarray(want)
    assert want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(diff.max()) <= 1 and float(np.mean(diff > 0)) <= 1e-5


def test_subsample_dv_arm():
    """The three planes of the torch arm (one packed fetch), of the NumPy
    arm and of the JAX arm, a partial window included (``_u8_close``)."""
    full, cur = (0, -1, 719, 478), (20, 10, 650, 470)
    data = _linear_frame(16, (4, 480, 720))
    data[:, :11] = 0
    with backend.force_backend(*TORCH_CPU):
        got = chroma.subsample_dv(_torch(data), box2i(*full), box2i(*cur))
    with backend.force_backend('numpy'):
        host = chroma.subsample_dv(_torch(data), box2i(*full), box2i(*cur))
    with ref_backend.force_backend('jax'):
        want = ref_chroma.subsample_dv(jnp.asarray(data), ref_box2i(*full),
                                       ref_box2i(*cur))
    for g, h, w in zip(got, host, want):
        _u8_close(g, h)
        _u8_close(g, w)


def test_subsample_mpeg2_arm():
    """Against the NumPy arm and the JAX arm (``_u8_close``)."""
    data = _linear_frame(17, (4, 480, 720)).astype(np.float32)
    with backend.force_backend(*TORCH_CPU):
        got = chroma.subsample_mpeg2(data, box2i(0, 0, 719, 479))
    with backend.force_backend('numpy'):
        host = chroma.subsample_mpeg2(data, box2i(0, 0, 719, 479))
    with ref_backend.force_backend('jax'):
        want = ref_chroma.subsample_mpeg2(data, ref_box2i(0, 0, 719, 479))
    for g, h, w in zip(got, host, want):
        _u8_close(g, h)
        _u8_close(g, w)


def test_pulldown_interleave_arm():
    """Pulldown's field interleave on tensors (``torch.where`` over the
    even rows) is bit-equal to the NumPy arm and the JAX arm."""
    from canvas_tpu import process as ref_process

    def clip(lib):
        return lib.Pulldown23RemovalFilter(lib.SolidColorVideoSource(
            lib.LerpFunc((0.9, 0.1, 0.2, 1.0), (0.1, 0.7, 0.8, 1.0), 10),
            lib.box2i(3, 1, 150, 96)), 0)

    win = (0, -1, 159, 98)
    for f in (2, 3, 6):      # mixed, solid, mixed cadence frames
        with backend.force_backend(*TORCH_CPU):
            got = clip(process).get_frame_f16(f, box2i(*win))
        with backend.force_backend('numpy'):
            host = clip(process).get_frame_f16(f, box2i(*win))
        with ref_backend.force_backend('jax'):
            want = clip(ref_process).get_frame_f16(f, ref_box2i(*win))
        assert isinstance(got.data, torch.Tensor)
        _bits_equal(got.data, host.data)
        _bits_equal(got.data, np.asarray(want.data))


# --- whole frames: the torch arm in 'auto' mode ------------------------------

W320 = (0, 0, 319, 179)


@pytest.fixture(scope='module')
def timelines_both():
    return {'headline': (bench.build_timeline(1024),
                         timelines.build_timeline(1024)),
            'config7': (benchmarks._mixed_timeline(256),
                        timelines.mixed_timeline(256))}


@pytest.mark.parametrize('case', ['headline-0', 'headline-130',
                                  'headline-1000', 'config7-0', 'config7-70'])
def test_whole_frame_torch_arm_matches_jax_and_numpy(timelines_both, case):
    """The port's 'auto' pull at 320x180 on the CPU takes the torch arm;
    against the JAX package's 'auto' pull (its JAX arm) and the port's
    NumPy arm: within 1 f16 ulp on >= 99.9% of values, and inside the
    render gates (headline atol 2e-3; config7 atol 1e-2 with >= 99%
    bit-equal)."""
    name, _, f = case.partition('-')
    f = int(f)
    ref_ws, port_ws = timelines_both[name]
    with backend.force_backend('auto', 'cpu'):
        frame = port_ws.get_frame_f16(f, box2i(*W320))
    assert isinstance(frame.data, torch.Tensor)
    got = frame.to_numpy()
    with backend.force_backend('numpy'):
        host = port_ws.get_frame_f16(f, box2i(*W320))
    with ref_backend.force_backend('auto'):
        want = ref_ws.get_frame_f16(f, ref_box2i(*W320))
    assert ref_backend.is_jax_array(want.data)
    assert frame.current_window == host.current_window
    assert tuple(frame.current_window.max) == tuple(want.current_window.max)
    atol, share = (2e-3, 0.0) if name == 'headline' else (1e-2, 0.99)
    for other in (host.data, np.asarray(want.data)):
        ulps = _f16_ulps(got, other)
        assert float(np.mean(ulps <= 1)) >= 0.999
        assert float(np.abs(got.astype(np.float32)
                            - other.astype(np.float32)).max()) <= atol
        assert float(np.mean(got.view(np.uint16)
                             == other.view(np.uint16))) >= share


# --- readers of a pulled frame ----------------------------------------------

def _torch_and_numpy_frames():
    src = timelines.build_timeline(64)
    with backend.force_backend(*TORCH_CPU):
        t = src.get_frame_f16(5, box2i(*W320))
    with backend.force_backend('numpy'):
        n = src.get_frame_f16(5, box2i(*W320))
    assert isinstance(t.data, torch.Tensor)
    assert isinstance(n.data, np.ndarray)
    return t, n


def test_frame_readers_accept_a_torch_arm_frame():
    t, n = _torch_and_numpy_frames()
    _bits_equal(t.to_numpy(), n.to_numpy())
    assert t.to_numpy() is t.to_numpy()            # fetched once
    for x, y in ((0, 0), (160, 90), (319, 179)):
        assert t.pixel(x, y) == n.pixel(x, y)
    for i in (0, 12345, len(n) - 1):
        assert t[i] == n[i]
    assert t.to_argb_string() == n.to_argb_string()
    t.data = t.data * 0                            # a new data object
    assert not t.to_numpy().any()


def test_write_video_eager_arm_takes_torch_frames(tmp_path, monkeypatch):
    """``write_video(use_batch=False)`` pulls on its producer thread under
    the caller's mode: a torch-arm pull on the CPU gives the same u8
    encoder input as the NumPy arm's."""
    from canvas_tpu_torch import libav
    got = {}
    for mode in (TORCH_CPU, ('numpy', None)):
        frames = got[mode[0]] = []
        orig = libav.AVMuxer.write_video_frame

        def write(self, stream, frame, frames=frames, orig=orig):
            frames.append(np.array(frame))
            return orig(self, stream, frame)

        monkeypatch.setattr(libav.AVMuxer, 'write_video_frame', write)
        with backend.force_backend(*mode):
            libav.write_video(str(tmp_path / ('%s.avi' % mode[0])),
                              timelines.build_timeline(64), None, 2, 6,
                              frame_size=(320, 180), frame_rate=25,
                              batch=2, format='avi', device='cpu',
                              use_batch=False)
        monkeypatch.undo()
    assert len(got['torch']) == len(got['numpy']) == 4
    for a, b in zip(got['torch'], got['numpy']):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_matroska_writer_takes_tensor_frames(tmp_path):
    """The Matroska PCM writer reads frames through ``backend.asnumpy``:
    an audio source whose frames carry tensors writes the same bytes."""
    from canvas_tpu_torch import audio, matroska

    class Tone(audio.AudioSource):
        def __init__(self, as_tensor):
            self.as_tensor = as_tensor

        def get_frame(self, min_sample, max_sample, channels):
            n = max_sample - min_sample + 1
            t = np.arange(min_sample, max_sample + 1)[:, None]
            data = (np.sin(t * 0.01 * (1 + np.arange(channels)))
                    .astype(np.float32))
            frame = audio.AudioFrame(min_sample, max_sample, channels,
                                     data=data)
            if self.as_tensor:
                frame.data = torch.from_numpy(data)
            assert frame.data.shape[0] == n
            return frame

    out = {}
    for as_tensor in (True, False):
        path = str(tmp_path / ('%s.mkv' % as_tensor))
        matroska.write_audio_pcm_float(path, Tone(as_tensor), 0, 4999,
                                       sample_rate=48000, channels=2)
        with open(path, 'rb') as fd:
            out[as_tensor] = fd.read()
    assert len(out[True]) > 5000 * 2 * 4 and out[True] == out[False]


def test_thumbnails_from_torch_arm_pulls():
    """Thumbnails of a source without ``plan_cuts`` (pulled eagerly by
    the queue, under the requesting thread's mode): a torch-arm pull on
    the CPU gives the NumPy arm's thumbnail."""
    from canvas_tpu_torch.editor.ui.thumbnails import ThumbnailPainter
    from canvas_tpu_torch.pullqueue import VideoPullQueue

    class Eager:
        def __init__(self, source):
            self.source = source

        def get_frame_f16(self, frame_index, window):
            return self.source.get_frame_f16(frame_index, window)

    thumbs = {}
    for mode in (TORCH_CPU, ('numpy', None)):
        queue = VideoPullQueue(device='cpu')
        painter = ThumbnailPainter(Eager(timelines.build_timeline(64)),
                                   window=box2i(*W320), size=(32, 18),
                                   count=2, queue=queue)
        painter.set_range(0, 40)
        with backend.force_backend(*mode):
            painter.request_all()
        queue.join(timeout=60)
        thumbs[mode[0]] = [painter.thumbnail(s) for s in (0, 1)]
        queue.close()
    for a, b in zip(thumbs['torch'], thumbs['numpy']):
        assert a is not None and a.shape == (18, 32, 4)
        np.testing.assert_array_equal(a, b)


def test_arms_follow_the_thread():
    """The mode is per thread: another thread keeps the default."""
    seen = {}

    def probe():
        seen['mode'] = backend.get_backend()

    with backend.force_backend(*TORCH_CPU):
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        assert backend.get_backend() == 'torch'
        assert backend.eager_device() == torch.device('cpu')
    assert seen['mode'] == backend._DEFAULT
