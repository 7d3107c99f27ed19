"""Toolkit-independent playback engine: the port's counterpart of
``canvas_tpu/playback.py`` (the reference's src/cprocess/widget_gl.c).

A render thread follows a presentation clock, renders frames ahead of
the presentation time into a small ring, and hands display-ready frames
to a host callback:

* the render thread renders *batches* ahead through the port's
  ``RenderPlanner.render`` on the device, so per-frame dispatch
  amortizes; the ring holds display-converted host frames;
* the display conversion runs on the device as part of the batch
  (an optional viewport resample, then the widget_gl soft-mode
  conversion, or the lossy yuv420 pack at quality <= 5), so only u8
  bytes cross to the host.

The engine renders on the planner's device: CUDA unless the caller
passes ``device='cpu'`` (the tests), which runs the same torch code on
CPU tensors. There is no host NumPy branch and no fallback.

The display sink is any callable ``present(frame_index, bgra_u8)`` where
bgra_u8 is an (H, W, 4) uint8 BGRA array.
"""

import atexit
import logging
import os
import threading
import time
import weakref
from fractions import Fraction

import torch

from canvas_tpu_torch import backend, process
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.render import RenderPlanner

log = logging.getLogger('canvas_tpu_torch.playback')

__all__ = ['VideoPlaybackEngine']

# The daemon render thread must not be killed mid-device-call at
# interpreter shutdown: CPython pthread_exit()s daemon threads when
# they next touch the GIL during finalization, which force-unwinds
# through the runtime's native frames and aborts the whole process. The
# atexit hook therefore stops engines whose owner never called stop(),
# then gives any thread still inside a device call a bounded join
# (CANVAS_EXIT_JOIN seconds, default 60, 0 disables) before teardown
# proceeds. Runs after threading._shutdown joins non-daemon threads and
# before daemon threads are frozen.
_live_engines = weakref.WeakSet()
_undead_threads = []     # threads that outlived their engine's stop()


@atexit.register
def _stop_live_engines():
    for engine in list(_live_engines):
        try:
            engine.stop(timeout=2.0)
        except Exception:
            log.warning('stopping playback engine at exit failed',
                        exc_info=True)
    budget = float(os.environ.get('CANVAS_EXIT_JOIN', '60') or 0)
    deadline = time.monotonic() + budget
    for thread in list(_undead_threads):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        thread.join(timeout=remaining)
    still = [t for t in _undead_threads if t.is_alive()]
    if still:
        log.warning(
            '%d playback render thread(s) still inside device calls '
            'after the %.0f s exit join; interpreter teardown may abort',
            len(still), budget)


def _viewport_resample(dy, dx, data):
    """Resample the (B, 4, H, W) f16 frames to the viewport: two f32
    contractions with (dh, H) and (dw, W) matrices, back to f16
    (playback.py:75-93)."""
    out = torch.einsum('yh,bchw->bcyw', dy, data.float())
    return torch.einsum('xw,bcyw->bcyx', dx, out).to(torch.float16)


class VideoPlaybackEngine:
    """Clock-driven playback of a video source.

    source: VideoSource; clock: PresentationClock; frame_rate: Fraction;
    window: display box2i; present: callback(frame_index, bgra (H,W,4) u8);
    device: the planner's torch device (None: CUDA, raising without it;
    'cpu' runs the plain versions of the kernels).
    """

    def __init__(self, source, clock, frame_rate, window, present,
                 batch=4, ring_frames=8, pixel_aspect_ratio=40.0 / 33.0,
                 rendering_intent=1.25, on_stall=None, device=None):
        self.source = source
        self.clock = clock
        self.frame_rate = Fraction(frame_rate)
        self.window = box2i(window)
        self.present = present
        self.batch = int(batch)
        self.ring_frames = int(ring_frames)
        self.device = backend.resolve_device(device)
        # Display semantics (widget_gl.c:818-969): defaults match the
        # reference (PAR 40/33 NTSC 4:3, rendering intent 1.25).
        self._pixel_aspect_ratio = float(pixel_aspect_ratio)
        self._rendering_intent = float(rendering_intent)
        self._viewport = None
        self._planner = None
        self._quality = 10
        #: Stall watchdog: a render batch blocked in a device call or a
        #: host pull can hold the render thread indefinitely; the app
        #: must LEARN about it (alert, don't freeze silently).
        #: on_stall(True) fires once when a batch exceeds
        #: stall_timeout (CANVAS_STALL_TIMEOUT, default 60 s),
        #: on_stall(False) when progress resumes; <= 0 disables the
        #: watchdog thread.
        self.on_stall = on_stall
        self.stall_timeout = float(os.environ.get('CANVAS_STALL_TIMEOUT',
                                                  '60'))
        self._batches_started = {}   # thread ident -> monotonic start
        self._stalled = False
        self._watch_stop = threading.Event()

        self._lock = threading.Lock()
        #: Serializes planner use: the long-lived RenderPlanner has
        #: per-plan mutable state (_stage_cache and friends), and both
        #: the render thread (_run) and display_frame callers reach
        #: _render_batch.
        self._render_lock = threading.Lock()
        self._wake = threading.Event()
        self._quit = False
        self._cache = {}            # frame_index -> u8 BGRA array
        self._clock_handle = self.clock.register_callback(
            self._clock_changed, None)
        # Live editor streams publish frames_updated(stream, lo, hi) when
        # model edits change content; drop the affected cached frames
        updated = getattr(source, 'frames_updated', None)
        if updated is not None:
            updated.connect(self._frames_updated)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='canvas-torch-playback')
        self._thread.start()
        self._watch_thread = None
        if self.stall_timeout > 0:
            self._watch_thread = threading.Thread(
                target=self._watch_stalls, daemon=True,
                name='canvas-torch-playback-stallwatch')
            self._watch_thread.start()
        _live_engines.add(self)

    def _watch_stalls(self):
        while not self._watch_stop.wait(min(5.0, self.stall_timeout / 4)):
            started_all = list(self._batches_started.values())
            started = min(started_all) if started_all else None
            stalled = (started is not None
                       and time.monotonic() - started > self.stall_timeout)
            if stalled == self._stalled:
                continue
            self._stalled = stalled
            if stalled:
                log.warning('playback render batch stalled for > %.0f s',
                            self.stall_timeout)
            else:
                log.info('playback render progress resumed')
            cb = self.on_stall
            if cb is not None:
                try:
                    cb(stalled)
                except Exception:
                    log.warning('on_stall callback failed', exc_info=True)

    @property
    def stalled(self):
        """True while a render batch has exceeded stall_timeout."""
        return self._stalled

    # -- clock integration (widget_gl.c:841 _clock_callback) -------------

    def _clock_changed(self, speed, time_ns, data):
        # Only a genuine position discontinuity (seek) invalidates the
        # ring: frame content doesn't depend on speed, and clearing on
        # every play/pause notification would re-render a full batch on
        # each resume.
        frame = self._frame_at(time_ns)
        playhead = getattr(self, '_playhead', None)
        if playhead is None or abs(frame - playhead) > max(self.batch, 4):
            with self._lock:
                self._cache.clear()
        self._wake.set()

    def _frames_updated(self, *args):
        # Accept (lo, hi) or (stream, lo, hi); None bounds = everything
        lo, hi = args[-2], args[-1]
        with self._lock:
            if lo is None and hi is None:
                self._cache.clear()
            else:
                lo = -10**12 if lo is None else lo
                hi = 10**12 if hi is None else hi
                for key in [k for k in self._cache if lo <= k <= hi]:
                    del self._cache[key]
        self._wake.set()

    # -- display semantics (widget_gl.c:818-969) --------------------------

    @property
    def display_window(self):
        return self.window

    def set_display_window(self, window):
        """Change the window frames are pulled into
        (widget_gl_set_display_window)."""
        with self._lock:
            self.window = box2i(window)
            self._cache.clear()
            # Re-clamp the viewport against the NEW window: a stored
            # viewport larger than a shrunk window would upscale on
            # device and fetch more bytes than full frames.
            vp = self._viewport
            if vp is not None:
                vp = (min(vp[0], self.window.width),
                      min(vp[1], self.window.height))
                if vp == (self.window.width, self.window.height):
                    vp = None
                self._viewport = vp
        self._wake.set()

    @property
    def pixel_aspect_ratio(self):
        return self._pixel_aspect_ratio

    def set_pixel_aspect_ratio(self, par):
        """Display pixel aspect ratio (width scale a widget applies;
        widget_gl.c:914-923). DV NTSC 4:3 uses 10/11."""
        self._pixel_aspect_ratio = float(par)
        self._wake.set()

    def display_size(self):
        """PAR-corrected size a display surface should use, as
        (width, height): source width scaled by the pixel aspect
        ratio (what the widget layers derive their viewport from)."""
        w = self.window.width
        h = self.window.height
        return (int(round(w * self._pixel_aspect_ratio)), h)

    @property
    def rendering_intent(self):
        return self._rendering_intent

    def set_rendering_intent(self, intent):
        """Additional display gamma (default 1.25;
        widget_gl_set_rendering_intent). Re-renders the ring."""
        intent = float(intent)
        if intent == self._rendering_intent:
            return
        self._rendering_intent = intent
        with self._lock:
            self._cache.clear()
        self._wake.set()

    def warm(self, frame=0):
        """Synchronously render the batch at *frame* through the full
        device pipeline (render, viewport resample, display conversion),
        so a following ``clock.play`` starts with those frames in the
        ring: the first batch also builds the kernels, and a clock that
        is already running skips every frame that falls inside that."""
        frame = self._clamp(int(frame))
        self._render_batch(frame, frame + self.batch)

    def stop(self, timeout=5.0):
        """Stop the render thread (joined up to *timeout* seconds) and
        release the planner. A thread stuck in a long device call can
        outlive the join — it exits on its own; a warning records that it
        was left running."""
        _live_engines.discard(self)
        self._quit = True
        self._wake.set()
        self._watch_stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            log.warning('playback render thread still busy at stop; '
                        'leaving it to exit in the background')
            # it must still finish before interpreter teardown (see
            # _stop_live_engines) or finalization aborts the process
            _undead_threads.append(self._thread)
        self._clock_handle.unregister()
        # A render thread stuck in a device call holds _render_lock;
        # stop() must not hang the UI thread behind it (the stall
        # watchdog's whole point).
        if self._render_lock.acquire(timeout=1.0):
            try:
                if self._planner is not None:
                    self._planner.close()
                    self._planner = None
            finally:
                self._render_lock.release()

    # -- render loop -----------------------------------------------------

    def _frame_at(self, time_ns):
        return process.get_time_frame(self.frame_rate, time_ns)

    def _get_planner(self, source, window):
        """One long-lived RenderPlanner per (source, window): the
        persistent device staging cache survives across batches, so a
        looped or replayed range renders from device memory with zero
        re-decode and re-staging (the render-ahead-ring intent,
        widget_gl.c:25,204-230, extended to whole segments)."""
        planner = self._planner
        if (planner is None or planner.source is not source
                or planner.window != window):
            if planner is not None:
                planner.close()
            planner = RenderPlanner(source, window, quality=self._quality,
                                    device=self.device)
            self._planner = planner
        return planner

    def set_quality(self, quality):
        """Render-quality hint for the display path (the reference's
        1-11 scale, framework.h:510-513; hints.rst intent): a UI sets
        quality <= 5 while scrubbing/dragging for cheaper scaler taps,
        bf16 accumulators and the lossy yuv420 transport, then restores
        10 on pause for the bit-exact frame."""
        quality = int(quality)
        with self._render_lock:
            planner = self._planner
            if planner is not None:
                if planner.quality == quality:
                    return
                planner.set_quality(quality)
        with self._lock:
            self._quality = quality
            self._cache.clear()
        self._wake.set()

    def set_viewport(self, size):
        """Viewport-sized display fetches: frames resample on device to
        (width, height) before the u8 conversion, so only viewport
        bytes cross to the host (the reference's soft mode paints at
        widget size, not source size — widget_gl.c:793-816). None
        restores full-size frames. Each axis clamps to the source size
        (upscaling on device would fetch MORE bytes than full frames;
        the widget's own blit scaling handles enlargement), and an
        unchanged viewport is a no-op (resize events repeat)."""
        if size is not None:
            w = min(int(size[0]), self.window.width)
            h = min(int(size[1]), self.window.height)
            size = (w, h)
            if size == (self.window.width, self.window.height):
                size = None
        with self._lock:
            if size == self._viewport:
                return
            self._viewport = size
            self._cache.clear()
        self._wake.set()

    def _render_batch(self, start, stop):
        # Per-thread start registry: warm()/display_frame() callers and
        # the render thread can be in _render_batch concurrently, and a
        # single shared scalar would be cleared by whichever finishes
        # first — blinding the stall watchdog to the survivor.
        ident = threading.get_ident()
        self._batches_started[ident] = time.monotonic()
        try:
            self._render_batch_inner(start, stop)
        finally:
            self._batches_started.pop(ident, None)

    def _render_batch_inner(self, start, stop):
        # Snapshot display state: if the source, window, or intent
        # changes while this batch is in flight, the results are stale —
        # drop them instead of caching frames from the old settings.
        source = self.source
        window = self.window
        intent = self._rendering_intent
        viewport = self._viewport
        quality = self._quality
        with self._lock:
            # Already rendered (warm() racing the render thread's own
            # first batch, or display_frame over a cached range): the
            # ring is cleared on every display-state change, so a full
            # cache hit is current — don't render and fetch it twice.
            if all(idx in self._cache for idx in range(start, stop)):
                return
        with self._render_lock:
            if self._quit:
                # stop() may have closed the planner while this thread
                # waited on the lock; don't resurrect one after teardown.
                return
            planner = self._get_planner(source, window)
            data = planner.render(start, stop, device_out=True)
            mats = planner._display_matrices(viewport)
        # Display conversion on the device (widget_gl soft mode: sRGB
        # transfer + rendering-intent ramp): only u8 crosses to the host,
        # viewport-sized when a viewport is set.
        if mats is not None:
            data = _viewport_resample(mats[0], mats[1], data)
        if quality <= 5:
            # Degraded scrub preview: the lossy 4:2:0 packed transport
            # (1.5 bytes/px against BGRA's 4); bit-exact BGRA returns
            # with quality >= 10.
            bgra = color_ops.yuv420_unpack_batch(
                backend.to_host(color_ops.yuv420_pack(data, intent)),
                data.shape[2], data.shape[3])
        else:
            # Lossless rgb24 transport: only the three color channels
            # cross (3 bytes/px against BGRA's 4); display surfaces blit
            # X-channel layouts, so the alpha byte pads on the host.
            bgra = color_ops.rgb24_unpack(backend.to_host(
                color_ops.display_u8(data, intent, order=(2, 1, 0))))
        with self._lock:
            if (source is not self.source or window is not self.window
                    or intent != self._rendering_intent
                    or viewport != self._viewport
                    or quality != self._quality):
                # display state changed while this batch was in flight:
                # the frames are stale (e.g. quality-4 frames finishing
                # after a quality-10 restore cleared the ring)
                return
            for i, idx in enumerate(range(start, stop)):
                self._cache[idx] = bgra[i]
            # Evict BEHIND the playhead — direction-aware: reverse
            # playback must drop the highest indices (already played),
            # not the upcoming low ones it just rendered (which would
            # livelock: every batch evicting itself and re-rendering).
            if len(self._cache) > self.ring_frames * 2:
                keys = sorted(self._cache)
                drop = (keys[:-self.ring_frames * 2]
                        if getattr(self, '_play_dir', 1) >= 0
                        else keys[self.ring_frames * 2:])
                for k in drop:
                    del self._cache[k]

    def set_video_source(self, source):
        """Swap the displayed source live
        (widget_gl_set_video_source)."""
        old = getattr(self, 'source', None)
        with self._lock:
            self.source = source
            self._cache.clear()
        old_updated = getattr(old, 'frames_updated', None)
        if old_updated is not None:
            try:
                old_updated.disconnect(self._frames_updated)
            except (ValueError, KeyError):
                pass
        updated = getattr(source, 'frames_updated', None)
        if updated is not None:
            updated.connect(self._frames_updated)
        self._wake.set()

    def set_frame_range(self, first, last):
        """Clamp playback to [first, last] (widget_gl firstFrame/
        lastFrame, widget_gl.c:236-239)."""
        self._first_frame = int(first)
        self._last_frame = int(last)
        self._wake.set()

    def display_frame(self, frame_index):
        """Render and present one frame immediately (paused preview /
        scrub; widget_gl_display_frame). Clamped to the frame range."""
        frame_index = self._clamp(int(frame_index))
        with self._lock:
            frame = self._cache.get(frame_index)
        if frame is None:
            self._render_batch(frame_index, frame_index + 1)
            with self._lock:
                frame = self._cache.get(frame_index)
        if frame is not None:
            self.present(frame_index, frame)

    def _clamp(self, frame):
        first = getattr(self, '_first_frame', None)
        last = getattr(self, '_last_frame', None)
        if first is not None and frame < first:
            return first
        if last is not None and frame > last:
            return last
        return frame

    def _run(self):
        last_presented = None
        while not self._quit:
            speed = self.clock.get_speed()
            now = self.clock.get_presentation_time()
            current = self._clamp(self._frame_at(now))
            self._playhead = current
            self._play_dir = 1 if speed >= 0 else -1

            with self._lock:
                have = current in self._cache

            if not have:
                try:
                    if speed >= 0:
                        self._render_batch(current, current + self.batch)
                    else:
                        # Reverse playback renders the batch *behind*
                        self._render_batch(current - self.batch + 1,
                                           current + 1)
                except Exception:
                    # A transient render failure (decode I/O, a device
                    # error) must not kill the render thread — that
                    # would freeze playback silently, where even the
                    # stall watchdog cannot see it. Log, back off, retry.
                    log.warning('render batch failed; retrying',
                                exc_info=True)
                    self._wake.wait(0.25)
                    self._wake.clear()
                    continue

            with self._lock:
                frame = self._cache.get(current)
            if frame is not None and current != last_presented:
                self.present(current, frame)
                last_presented = current

            if speed == 0:
                self._wake.wait()
                self._wake.clear()
                continue

            # Render ahead while waiting for the next frame time
            # (speed-aware timeout, widget_gl.c:122-181)
            next_frame = current + (1 if speed > 0 else -1)
            with self._lock:
                ahead_missing = [
                    i for i in (range(next_frame,
                                      next_frame + self.batch) if speed > 0
                                else range(next_frame - self.batch + 1,
                                           next_frame + 1))
                    if i not in self._cache]
            if ahead_missing:
                if speed > 0:
                    self._render_batch(min(ahead_missing),
                                       min(ahead_missing) + self.batch)
                else:
                    self._render_batch(max(ahead_missing) - self.batch + 1,
                                       max(ahead_missing) + 1)

            next_time = process.get_frame_time(self.frame_rate, next_frame)
            now = self.clock.get_presentation_time()
            # signed division: reverse playback approaches next_time
            # from above (both terms negative -> positive wait)
            delta_ns = (next_time - now) / float(speed)
            if delta_ns > 0:
                self._wake.wait(min(delta_ns / 1e9, 0.25))
                self._wake.clear()
