"""The port's presentation clock (canvas_tpu_torch.clock) and playback
engine (canvas_tpu_torch.playback.VideoPlaybackEngine) on the CPU
(``device='cpu'``: the same torch code on CPU tensors, the kernels'
plain versions).

The clock tests and the engine tests are ports of
tests/test_clock_playback.py (20-70 and 103-240): presents frames, warm,
seek, lifecycle with no thread leak, PAR and intent; then the viewport
and quality-5 cases, and the bytes an engine presents against the JAX
package's engine (canvas_tpu.playback) for the same source and settings:
equal. Every wait has a deadline of at most 10 s.
"""

import threading
import time
from fractions import Fraction

import numpy as np
import pytest

from canvas_tpu import playback as ref_playback
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.clock import SystemPresentationClock as RefClock
from canvas_tpu.framefuncs import LerpFunc as RefLerp
from canvas_tpu_torch import playback as port_playback
from canvas_tpu_torch import process
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.clock import SystemPresentationClock
from canvas_tpu_torch.framefuncs import LerpFunc
from canvas_tpu_torch.ops import color
from canvas_tpu_torch.signal import Signal
from canvas_tpu_torch.sources import SolidColorVideoSource, VideoScaler

DEADLINE = 10.0


def _wait(cond, budget=DEADLINE):
    deadline = time.time() + budget
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def _engine(src, clock, rate, window, present, **kw):
    return port_playback.VideoPlaybackEngine(src, clock, rate, window,
                                             present, device='cpu', **kw)


# --- the clock (test_clock_playback.py:20-70) ---------------------------

def test_clock_callback():
    results = []

    def callback(speed, time_ns, data):
        data.append((speed, time_ns))

    clock = process.SystemPresentationClock()
    handle = clock.register_callback(callback, results)
    clock.play(1)
    assert results[0] == (Fraction(1, 1), 0)
    clock.stop()
    assert results[1][0] == Fraction(0, 1)
    t = results[1][1]
    clock.play(Fraction(-1, 2))
    assert results[2] == (Fraction(-1, 2), t)
    clock.seek(200)
    assert results[3] == (Fraction(-1, 2), 200)
    handle.unregister()
    clock.stop()
    assert len(results) == 4


def test_clock_seek_and_advance():
    clock = SystemPresentationClock()
    clock.seek(100)
    assert clock.get_presentation_time() == 100
    clock.set(Fraction(2, 1), 0)
    time.sleep(0.05)
    t = clock.get_presentation_time()
    assert 50_000_000 < t < 400_000_000       # 50 ms at 2x
    clock.stop()
    frozen = clock.get_presentation_time()
    time.sleep(0.02)
    assert clock.get_presentation_time() == frozen


def test_clock_negative_speed():
    clock = SystemPresentationClock()
    clock.set(Fraction(-1, 1), 1_000_000_000)
    time.sleep(0.05)
    assert clock.get_presentation_time() < 1_000_000_000


# --- the engine (test_clock_playback.py:103-240) ------------------------

def test_playback_engine_presents_frames():
    presented = []
    src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 100))
    clock = SystemPresentationClock()
    engine = _engine(src, clock, Fraction(100, 1), box2i(0, 0, 15, 15),
                     lambda idx, bgra: presented.append((idx, bgra.shape)))
    try:
        clock.play(1)
        _wait(lambda: len(presented) >= 3)
        clock.stop()
        assert len(presented) >= 2
        assert presented[0][1] == (16, 16, 4)
        indices = [p[0] for p in presented]
        assert indices == sorted(indices)
    finally:
        engine.stop()


def test_playback_engine_warm_fills_the_ring():
    presented = []
    src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 100))
    clock = SystemPresentationClock()
    engine = _engine(src, clock, Fraction(100, 1), box2i(0, 0, 15, 15),
                     lambda idx, bgra: presented.append(idx), batch=4)
    try:
        engine.warm(0)
        with engine._lock:
            cached = sorted(engine._cache)
        assert cached[:4] == [0, 1, 2, 3]
        assert _wait(lambda: bool(presented))
        n = len(presented)
        engine.display_frame(0)        # from the ring, no re-render
        assert len(presented) == n + 1
        assert set(presented) == {0}
    finally:
        engine.stop()


def test_playback_seek_invalidates():
    presented = []
    clock = SystemPresentationClock()
    engine = _engine(SolidColorVideoSource((0, 1, 0, 1)), clock,
                     Fraction(100, 1), box2i(0, 0, 7, 7),
                     lambda idx, bgra: presented.append(idx))
    try:
        clock.seek(0)
        assert _wait(lambda: bool(presented))
        clock.seek(50 * 10_000_000)    # frame 50 at 100 fps
        assert _wait(lambda: 50 in presented)
    finally:
        engine.stop()


def test_engine_lifecycle_no_thread_leak():
    base = threading.active_count()
    src = SolidColorVideoSource((0.5, 0.5, 0.5, 1.0))
    for _ in range(5):
        clock = SystemPresentationClock()
        eng = _engine(src, clock, Fraction(30, 1), box2i(0, 0, 15, 15),
                      lambda *a: None)
        eng.display_frame(0)
        eng.stop()
        assert not eng._thread.is_alive()
        assert eng._planner is None
    assert _wait(lambda: threading.active_count() - base <= 2, 2.0)


def test_display_semantics_par_and_intent():
    """widget_gl display parity (widget_gl.c:818-969): the DV 10:11
    pixel aspect ratio, the display window override, and a rendering
    intent switch re-rendering with the new ramp."""
    presented = []
    src = SolidColorVideoSource((0.25, 0.5, 0.75, 1.0))
    clock = SystemPresentationClock()
    engine = _engine(src, clock, Fraction(30000, 1001),
                     box2i(0, -1, 719, 478),
                     lambda idx, bgra: presented.append((idx, bgra)))
    try:
        assert abs(engine.pixel_aspect_ratio - 40.0 / 33.0) < 1e-6
        assert engine.rendering_intent == 1.25
        engine.set_pixel_aspect_ratio(10.0 / 11.0)
        assert engine.display_size() == (655, 480)
        engine.set_display_window(box2i(0, 0, 99, 79))
        assert engine.display_size() == (91, 80)

        clock.play(1)
        assert _wait(lambda: bool(presented))
        clock.stop()
        _, bgra = presented[0]
        assert bgra.shape == (80, 100, 4)
        lin = np.zeros((4, 1, 1), np.float16)
        lin[:, 0, 0] = (0.25, 0.5, 0.75, 1.0)
        want = color.apply_display_u8(lin, 1.25)[:, 0, 0]
        got_px = bgra[40, 50]
        assert tuple(got_px) == (want[2], want[1], want[0], 255)

        presented.clear()
        engine.set_rendering_intent(1.0)
        clock.seek(0)
        clock.play(1)
        assert _wait(lambda: bool(presented))
        clock.stop()
        want1 = color.apply_display_u8(lin, 1.0)[:, 0, 0]
        got_px1 = presented[0][1][40, 50]
        assert tuple(got_px1) == (want1[2], want1[1], want1[0], 255)
        assert tuple(got_px1) != tuple(got_px)
    finally:
        engine.stop()


# --- viewport, quality, and the JAX engine's bytes ----------------------

def test_playback_viewport_fetch():
    """set_viewport: frames resample on the device to the viewport before
    the conversion; None restores full size; the viewport clamps to a
    shrunk display window."""
    presented = []
    clock = SystemPresentationClock()
    engine = _engine(SolidColorVideoSource((0.25, 0.5, 0.75, 1.0)), clock,
                     Fraction(24), box2i(0, 0, 639, 479),
                     lambda idx, bgra: presented.append((idx, bgra)))
    try:
        engine.set_viewport((160, 120))
        engine.display_frame(3)
        _, bgra = presented[-1]
        assert bgra.shape == (120, 160, 4)
        lin = np.zeros((4, 1, 1), np.float16)
        lin[:, 0, 0] = (0.25, 0.5, 0.75, 1.0)
        want = color.apply_display_u8(lin, 1.25)[:, 0, 0]
        got = bgra[60, 80].astype(int)
        assert np.abs(got[:3] - want[2::-1].astype(int)).max() <= 1
        engine.set_viewport(None)
        engine.display_frame(4)
        assert presented[-1][1].shape == (480, 640, 4)
        engine.set_viewport((400, 300))
        engine.set_display_window(box2i(0, 0, 199, 479))
        assert engine._viewport == (200, 300)
    finally:
        engine.stop()


def _scaler(lib, lerp, box):
    base = lib.SolidColorVideoSource(
        lerp((0.8, 0.3, 0.2, 1.0), (0.2, 0.7, 0.9, 1.0), 32),
        window=box(0, 0, 127, 95))
    return lib.VideoScaler(
        base, target_point=lerp((4, 2), (10, 8), 32),
        source_point=(0.0, 0.0),
        scale_factors=lerp((0.4, 0.4), (0.45, 0.5), 32),
        source_rect=box(0, 0, 127, 95))


class _Port:
    SolidColorVideoSource = SolidColorVideoSource
    VideoScaler = VideoScaler


def test_playback_engine_quality_5():
    """set_quality(5): lq taps, bf16 accumulators and the lossy yuv420
    transport give a different but recognisable preview; quality 10
    restores the exact frame (test_clock_playback.py:507-549)."""
    presented = {}
    clock = SystemPresentationClock()
    engine = _engine(_scaler(_Port, LerpFunc, box2i), clock, Fraction(24),
                     box2i(0, 0, 63, 63),
                     lambda idx, bgra: presented.__setitem__(idx,
                                                             bgra.copy()))
    try:
        engine.display_frame(3)
        full = presented.pop(3)
        engine.set_quality(5)
        assert engine._planner.quality == 5
        engine.display_frame(3)
        fast = presented.pop(3)
        assert not np.array_equal(full, fast)
        diff = np.abs(fast[20:40, 20:40, :3].astype(np.int32)
                      - full[20:40, 20:40, :3].astype(np.int32))
        assert diff.max() <= 4, diff.max()
        assert (fast[..., 3] == 255).all()
        engine.set_quality(10)
        engine.display_frame(3)
        np.testing.assert_array_equal(full, presented.pop(3))
    finally:
        engine.stop()


class _Ref:
    SolidColorVideoSource = ref_sources.SolidColorVideoSource
    VideoScaler = ref_sources.VideoScaler


@pytest.mark.parametrize('settings', [
    {}, {'viewport': (40, 24)}, {'quality': 5}, {'intent': 1.0},
    {'quality': 9, 'viewport': (33, 21)}])
def test_display_frame_bytes_match_the_jax_engine(settings):
    """Paused display_frame of the same scaler graph, built by each
    package, through each package's engine: the presented bytes are
    equal."""
    frames = {}

    def run(mod, lib, lerp, box, clock, **kw):
        got = {}
        engine = mod.VideoPlaybackEngine(
            _scaler(lib, lerp, box), clock, Fraction(24), box(0, 0, 63, 47),
            lambda idx, bgra: got.__setitem__(idx, bgra.copy()), **kw)
        try:
            if 'quality' in settings:
                engine.set_quality(settings['quality'])
            if 'viewport' in settings:
                engine.set_viewport(settings['viewport'])
            if 'intent' in settings:
                engine.set_rendering_intent(settings['intent'])
            for i in (0, 3, 17):
                engine.display_frame(i)
        finally:
            engine.stop()
        return got

    frames['jax'] = run(ref_playback, _Ref, RefLerp, ref_box2i, RefClock())
    frames['port'] = run(port_playback, _Port, LerpFunc, box2i,
                         SystemPresentationClock(), device='cpu')
    assert sorted(frames['port']) == sorted(frames['jax']) == [0, 3, 17]
    for i in (0, 3, 17):
        got, want = frames['port'][i], frames['jax'][i]
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_playback_frames_updated_drops_the_ring():
    """A source's frames_updated (the port's Signal) drops the affected
    ring entries; set_video_source follows the new source's signal."""
    src1 = SolidColorVideoSource((1, 0, 0, 1))
    src1.frames_updated = Signal()
    src2 = SolidColorVideoSource((0, 1, 0, 1))
    src2.frames_updated = Signal()
    engine = _engine(src1, SystemPresentationClock(), Fraction(30, 1),
                     box2i(0, 0, 15, 15), lambda idx, bgra: None)
    try:
        with engine._lock:
            engine._cache[7] = 'sentinel'
        src1.frames_updated(None, None)
        assert 7 not in engine._cache
        engine.set_video_source(src2)
        with engine._lock:
            engine._cache[9] = 'sentinel'
        src1.frames_updated(None, None)        # disconnected
        assert 9 in engine._cache
        src2.frames_updated(5, 12)
        assert 9 not in engine._cache
    finally:
        engine.stop()


def test_default_device_is_cuda_and_raises_without_it():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        port_playback.VideoPlaybackEngine(
            SolidColorVideoSource((1, 0, 0, 1)), SystemPresentationClock(),
            Fraction(30, 1), box2i(0, 0, 15, 15), lambda *a: None)
