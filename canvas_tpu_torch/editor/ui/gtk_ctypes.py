"""REAL-GTK video widget over a ctypes binding + the Broadway display
(the port's counterpart of ``canvas_tpu.editor.ui.gtk_ctypes``).

The reference's GTK widget is C against libgtk
(src/gtk/GtkVideoWidget.c:44-132). A host without PyGObject may still
have the real GTK 3 libraries and ``broadwayd`` (GTK's HTML5 display
server) — so this module binds libgtk-3 / libgobject / libcairo /
libgdk_pixbuf directly with ctypes (the same approach as the ALSA sink,
canvas_tpu_torch/audioout.py) and runs the actual toolkit headlessly: a
real GtkWindow + GtkDrawingArea, the engine's BGRA frames painted
through a real cairo context in a real ``draw`` signal, and pixels read
back from the realized GdkWindow with gdk_pixbuf_get_from_window for
assertions. The widget's playback engine renders on its ``device``
(None: the card).

The fake-binding shims exercise the widget logic, this executes the
toolkit itself. ``python -m canvas_tpu_torch.editor.ui.gtk_ctypes
[--device cpu|cuda] [--paint]`` runs the self-test standalone (in a
process of its own: gtk_init is process-global).
"""

import ctypes as C
import os
import shutil
import subprocess
import time

__all__ = ['broadway_available', 'start_broadwayd', 'GtkCtypesVideoWidget']

GTK_WINDOW_TOPLEVEL = 0
CAIRO_FORMAT_RGB24 = 1

_libs = None


def _load_libs():
    """Load and prototype the GTK/cairo libraries; None if unavailable."""
    global _libs
    if _libs is not None:
        return _libs
    try:
        gtk = C.CDLL('libgtk-3.so.0')
        gdk = C.CDLL('libgdk-3.so.0')
        gobject = C.CDLL('libgobject-2.0.so.0')
        glib = C.CDLL('libglib-2.0.so.0')
        cairo = C.CDLL('libcairo.so.2')
        pixbuf = C.CDLL('libgdk_pixbuf-2.0.so.0')
    except OSError:
        _libs = False
        return _libs

    for lib, name, res, args in [
        (gtk, 'gtk_init_check', C.c_int, [C.c_void_p, C.c_void_p]),
        (gtk, 'gtk_window_new', C.c_void_p, [C.c_int]),
        (gtk, 'gtk_window_resize', None, [C.c_void_p, C.c_int, C.c_int]),
        (gtk, 'gtk_drawing_area_new', C.c_void_p, []),
        (gtk, 'gtk_container_add', None, [C.c_void_p, C.c_void_p]),
        (gtk, 'gtk_widget_show_all', None, [C.c_void_p]),
        (gtk, 'gtk_widget_set_size_request', None,
         [C.c_void_p, C.c_int, C.c_int]),
        (gtk, 'gtk_widget_queue_draw', None, [C.c_void_p]),
        (gtk, 'gtk_widget_get_window', C.c_void_p, [C.c_void_p]),
        (gtk, 'gtk_widget_destroy', None, [C.c_void_p]),
        (gtk, 'gtk_main_iteration_do', C.c_int, [C.c_int]),
        (gtk, 'gtk_events_pending', C.c_int, []),
        (gdk, 'gdk_pixbuf_get_from_window', C.c_void_p,
         [C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int]),
        (gdk, 'gdk_window_process_all_updates', None, []),
        (gobject, 'g_signal_connect_data', C.c_ulong,
         [C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
          C.c_int]),
        (gobject, 'g_object_unref', None, [C.c_void_p]),
        (glib, 'g_idle_add', C.c_uint, [C.c_void_p, C.c_void_p]),
        (cairo, 'cairo_image_surface_create_for_data', C.c_void_p,
         [C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int]),
        (cairo, 'cairo_set_source_surface', None,
         [C.c_void_p, C.c_void_p, C.c_double, C.c_double]),
        (cairo, 'cairo_set_source_rgb', None,
         [C.c_void_p, C.c_double, C.c_double, C.c_double]),
        (cairo, 'cairo_paint', None, [C.c_void_p]),
        (cairo, 'cairo_surface_destroy', None, [C.c_void_p]),
        (pixbuf, 'gdk_pixbuf_get_pixels', C.POINTER(C.c_ubyte),
         [C.c_void_p]),
        (pixbuf, 'gdk_pixbuf_get_rowstride', C.c_int, [C.c_void_p]),
        (pixbuf, 'gdk_pixbuf_get_width', C.c_int, [C.c_void_p]),
        (pixbuf, 'gdk_pixbuf_get_height', C.c_int, [C.c_void_p]),
        (pixbuf, 'gdk_pixbuf_get_n_channels', C.c_int, [C.c_void_p]),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args

    _libs = {'gtk': gtk, 'gdk': gdk, 'gobject': gobject, 'glib': glib,
             'cairo': cairo, 'pixbuf': pixbuf}
    return _libs


def broadway_available():
    """True when both broadwayd and the GTK 3 libraries are present."""
    return bool(shutil.which('broadwayd')) and bool(_load_libs())


def start_broadwayd(display=None, port=None):
    """Start a broadwayd display server; returns (proc, display_str).

    The caller must set GDK_BACKEND=broadway and
    BROADWAY_DISPLAY=<display_str> BEFORE the first gtk_init in the
    process. Display/port default to pid-derived values so parallel
    test runs don't collide; stale sockets from a crashed server are
    removed first (broadwayd refuses to listen otherwise).
    """
    if display is None:
        display = 50 + os.getpid() % 400
    if port is None:
        port = 18000 + os.getpid() % 2000
    # broadwayd names its socket off the display number + 1
    for cand in (display, display + 1):
        sock = os.path.expanduser('~/.cache/broadway%d.socket' % cand)
        if os.path.exists(sock):
            try:
                os.unlink(sock)
            except OSError:
                pass
    proc = subprocess.Popen(
        ['broadwayd', '--address', '127.0.0.1', '--port', str(port),
         ':%d' % display],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    time.sleep(0.5)
    if proc.poll() is not None:
        raise RuntimeError('broadwayd exited with %r' % proc.returncode)
    return proc, ':%d' % display


_DrawCb = C.CFUNCTYPE(C.c_int, C.c_void_p, C.c_void_p, C.c_void_p)
_IdleCb = C.CFUNCTYPE(C.c_int, C.c_void_p)

_initialized = False


def _ensure_gtk(display=None):
    global _initialized
    libs = _load_libs()
    if not libs:
        raise RuntimeError('GTK 3 libraries not available')
    if not _initialized:
        os.environ.setdefault('GDK_BACKEND', 'broadway')
        if display is not None:
            os.environ['BROADWAY_DISPLAY'] = display
        if not libs['gtk'].gtk_init_check(None, None):
            raise RuntimeError('gtk_init_check failed (no display? set '
                               'BROADWAY_DISPLAY and start broadwayd)')
        _initialized = True
    return libs


class GtkCtypesVideoWidget:
    """Real-GTK video widget: same engine wiring as
    editor/ui/gtk.py's PyGObject widget (GtkVideoWidget.c parity), but
    through the ctypes binding — frames from the playback engine's
    render thread hop onto the GTK main loop with g_idle_add (the
    reference's g_timeout_add pattern, GtkVideoWidget.c:56-70) and
    paint in a real ``draw`` signal via cairo."""

    def __init__(self, source, clock, frame_rate, window,
                 pixel_aspect_ratio=40.0 / 33.0, rendering_intent=1.25,
                 on_stall=None, display=None, device=None):
        self._libs = _ensure_gtk(display)
        gtk = self._libs['gtk']
        from canvas_tpu_torch.playback import VideoPlaybackEngine

        self._frame = None            # (bytes, w, h) under _lock
        self._painted = 0             # draw-signal executions with a frame
        self._last_index = None
        import threading
        self._lock = threading.Lock()

        self.window_ptr = gtk.gtk_window_new(GTK_WINDOW_TOPLEVEL)
        self.area = gtk.gtk_drawing_area_new()
        gtk.gtk_container_add(self.window_ptr, self.area)

        # keep callback objects alive for the widget's lifetime
        self._draw_cb = _DrawCb(self._on_draw)
        self._libs['gobject'].g_signal_connect_data(
            self.area, b'draw', C.cast(self._draw_cb, C.c_void_p),
            None, None, 0)
        self._idle_cb = _IdleCb(self._on_idle)

        self._engine = VideoPlaybackEngine(
            source, clock, frame_rate, window, self._present,
            pixel_aspect_ratio=pixel_aspect_ratio,
            rendering_intent=rendering_intent, on_stall=on_stall,
            device=device)
        w, h = self._engine.display_size()
        gtk.gtk_widget_set_size_request(self.area, w, h)
        gtk.gtk_widget_show_all(self.window_ptr)

    @property
    def engine(self):
        return self._engine

    # -- engine render thread -> GTK main loop ------------------------
    def _present(self, frame_index, bgra):
        # Keep the raw BGRA bytes; cairo RGB24 reads them as xRGB
        # little-endian (alpha byte ignored). Copy: the engine reuses
        # its buffers.
        h, w = bgra.shape[:2]
        buf = bytes(bgra.tobytes())
        with self._lock:
            self._frame = (buf, w, h)
            self._last_index = frame_index
        self._libs['glib'].g_idle_add(
            C.cast(self._idle_cb, C.c_void_p), None)

    def _on_idle(self, _data):
        # A present() scheduled just before close() may fire after the
        # widget tree is destroyed; queue_draw on a destroyed GtkWidget
        # is a use-after-free in C.
        if not getattr(self, '_closed', False):
            self._libs['gtk'].gtk_widget_queue_draw(self.area)
        return 0                      # one-shot

    def _on_draw(self, _widget, cr, _data):
        cairo = self._libs['cairo']
        with self._lock:
            frame = self._frame
        if frame is None:
            cairo.cairo_set_source_rgb(cr, 0.0, 0.0, 0.0)
            cairo.cairo_paint(cr)
            return 0
        buf, w, h = frame
        # the surface borrows buf; keep it alive until destroyed
        self._paint_buf = C.create_string_buffer(buf, len(buf))
        surf = cairo.cairo_image_surface_create_for_data(
            self._paint_buf, CAIRO_FORMAT_RGB24, w, h, w * 4)
        cairo.cairo_set_source_surface(cr, surf, 0.0, 0.0)
        cairo.cairo_paint(cr)
        cairo.cairo_surface_destroy(surf)
        self._painted += 1
        return 0

    # -- test helpers --------------------------------------------------
    def pump(self, seconds=0.1):
        """Run the real GTK main loop for *seconds*."""
        gtk = self._libs['gtk']
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            while gtk.gtk_events_pending():
                gtk.gtk_main_iteration_do(0)
            time.sleep(0.005)
        while gtk.gtk_events_pending():
            gtk.gtk_main_iteration_do(0)

    def wait_painted(self, n=1, timeout=10.0):
        """Pump until the draw signal has painted >= n engine frames."""
        deadline = time.monotonic() + timeout
        while self._painted < n and time.monotonic() < deadline:
            self.pump(0.05)
        return self._painted >= n

    def read_pixels(self, w, h):
        """(h, w, 3) u8 RGB read back from the REALIZED GdkWindow."""
        import numpy as np
        libs = self._libs
        gw = libs['gtk'].gtk_widget_get_window(self.area)
        if not gw:
            raise RuntimeError('widget not realized')
        pb = libs['gdk'].gdk_pixbuf_get_from_window(gw, 0, 0, w, h)
        if not pb:
            raise RuntimeError('gdk_pixbuf_get_from_window failed')
        try:
            pw = libs['pixbuf'].gdk_pixbuf_get_width(pb)
            ph = libs['pixbuf'].gdk_pixbuf_get_height(pb)
            nch = libs['pixbuf'].gdk_pixbuf_get_n_channels(pb)
            stride = libs['pixbuf'].gdk_pixbuf_get_rowstride(pb)
            p = libs['pixbuf'].gdk_pixbuf_get_pixels(pb)
            # A pixbuf buffer is (ph-1)*stride + pw*nch bytes — the
            # LAST row is NOT padded to the stride, so a (ph, stride)
            # view would read past the allocation when pw*nch < stride.
            nbytes = (ph - 1) * stride + pw * nch
            flat = np.ctypeslib.as_array(p, shape=(nbytes,))
            out = np.empty((ph, pw, nch), np.uint8)
            for r in range(ph):
                row = flat[r * stride:r * stride + pw * nch]
                out[r] = row.reshape(pw, nch)
            out = out[:, :, :3].copy()
        finally:
            libs['gobject'].g_object_unref(pb)
        return out

    def close(self):
        self._closed = True
        self._engine.stop()
        self._libs['gtk'].gtk_widget_destroy(self.window_ptr)


class GtkCtypesBlitWidget:
    """Real-GTK window that paints an arbitrary BGRA u8 buffer — used
    to run the editor's software timeline rasterizer (editor/ui/paint.py
    CanvasPainter) through the ACTUAL toolkit and read the pixels back
    from the realized window."""

    def __init__(self, width, height, display=None):
        self._libs = _ensure_gtk(display)
        gtk = self._libs['gtk']
        self._frame = None
        self.window_ptr = gtk.gtk_window_new(GTK_WINDOW_TOPLEVEL)
        self.area = gtk.gtk_drawing_area_new()
        gtk.gtk_container_add(self.window_ptr, self.area)
        self._draw_cb = _DrawCb(self._on_draw)
        self._libs['gobject'].g_signal_connect_data(
            self.area, b'draw', C.cast(self._draw_cb, C.c_void_p),
            None, None, 0)
        gtk.gtk_widget_set_size_request(self.area, width, height)
        gtk.gtk_widget_show_all(self.window_ptr)
        self.painted = 0

    def set_frame(self, bgra):
        h, w = bgra.shape[:2]
        self._frame = (bytes(bgra.tobytes()), w, h)
        self._libs['gtk'].gtk_widget_queue_draw(self.area)

    def _on_draw(self, _widget, cr, _data):
        cairo = self._libs['cairo']
        if self._frame is None:
            cairo.cairo_set_source_rgb(cr, 0.0, 0.0, 0.0)
            cairo.cairo_paint(cr)
            return 0
        buf, w, h = self._frame
        self._paint_buf = C.create_string_buffer(buf, len(buf))
        surf = cairo.cairo_image_surface_create_for_data(
            self._paint_buf, CAIRO_FORMAT_RGB24, w, h, w * 4)
        cairo.cairo_set_source_surface(cr, surf, 0.0, 0.0)
        cairo.cairo_paint(cr)
        cairo.cairo_surface_destroy(surf)
        self.painted += 1
        return 0

    pump = GtkCtypesVideoWidget.pump
    read_pixels = GtkCtypesVideoWidget.read_pixels

    def close(self):
        self._libs['gtk'].gtk_widget_destroy(self.window_ptr)


def _selftest_paint():
    """Timeline rasterizer -> real GTK window -> pixel readback."""
    import fractions
    import json

    import numpy as np

    from canvas_tpu_torch import timecode
    from canvas_tpu_torch.editor import model, plugins
    from canvas_tpu_torch.editor.ui.canvas_models import (CanvasSceneModel,
                                                          SnapMarker,
                                                          ViewTransformModel)
    from canvas_tpu_torch.editor.ui.paint import THEME, CanvasPainter
    from canvas_tpu_torch.editor.ui.ruler import TimeRulerModel

    space = model.Space('s', plugins.VideoFormat(frame_rate=10),
                        plugins.AudioFormat(sample_rate=48000))
    clip = model.Clip(type='video', x=10, y=0.0, length=40, height=1.0)
    space[0:0] = [clip]
    scene = CanvasSceneModel(space)
    transform = ViewTransformModel(pixels_per_second=32.0,
                                   pixels_per_lane=30.0)
    transform.add_marker(SnapMarker('x', 3.5))
    ruler = TimeRulerModel(timecode.Frames(),
                           scale=fractions.Fraction(32, 10),
                           frame_rate=fractions.Fraction(10, 1))
    painter = CanvasPainter(scene, transform, ruler=ruler)
    buf = painter.paint(320, 120, playhead_frame=20, playhead_rate=10)

    proc, display = start_broadwayd()
    try:
        w = GtkCtypesBlitWidget(320, 120, display=display)
        try:
            w.pump(0.3)
            w.set_frame(buf)
            deadline = time.time() + 10
            while w.painted < 1 and time.time() < deadline:
                w.pump(0.05)
            w.pump(0.2)
            px = w.read_pixels(320, 120)
            top = painter.ruler_height
            # CanvasPainter buffers are BGRA; the window reads back RGB
            clip_rgb = px[top + 12, 48].tolist()
            want = list(THEME['clip_video'][2::-1])
            print(json.dumps({
                'painted': w.painted,
                'clip_rgb': clip_rgb,
                'want_clip_rgb': want,
                'match': clip_rgb == want,
            }), flush=True)
        finally:
            w.close()
    finally:
        proc.terminate()
        proc.wait()


def _selftest(device=None):
    """Drive the real toolkit end-to-end: engine (rendering on *device*)
    -> draw signal -> GdkWindow pixels. Prints one line of JSON for the
    test harness."""
    import json

    from canvas_tpu_torch.basetypes import box2i
    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.sources import SolidColorVideoSource
    import fractions

    proc, display = start_broadwayd()
    try:
        src = SolidColorVideoSource((0.0, 1.0, 0.0, 1.0))  # green
        clock = SystemPresentationClock()
        widget = GtkCtypesVideoWidget(
            src, clock, fractions.Fraction(30), box2i(0, 0, 159, 119),
            pixel_aspect_ratio=1.0, display=display, device=device)
        try:
            clock.seek(0)
            ok_paint = widget.wait_painted(1, timeout=15.0)
            widget.pump(0.2)
            px = widget.read_pixels(32, 32)
            center = px[16, 16].tolist()
            print(json.dumps({
                'painted': widget._painted,
                'ok_paint': bool(ok_paint),
                'center_rgb': center,
                'frame_index': widget._last_index,
            }), flush=True)
        finally:
            widget.close()
    finally:
        proc.terminate()
        proc.wait()


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description='Self-test of the real GTK widget on a Broadway '
                    'display: prints one line of JSON.')
    parser.add_argument('--paint', action='store_true',
                        help='blit the timeline rasterizer instead of '
                             'playing video')
    parser.add_argument('--device', default=None,
                        help="the playback engine's device (default: the "
                             "card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    if args.paint:
        _selftest_paint()
    else:
        _selftest(args.device)


if __name__ == '__main__':
    main()
