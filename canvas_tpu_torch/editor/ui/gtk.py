"""GTK video widget shim (the port's counterpart of
``canvas_tpu.editor.ui.gtk``).

Equivalent of the reference's GTK video widget
(src/gtk/GtkVideoWidget.c:44-132): a drawing area over the
toolkit-independent playback engine (canvas_tpu_torch.playback), which
renders on the widget's ``device`` (None: the card). Imports lazily and
degrades gracefully — without PyGObject the module's ``gtk_available()``
is False and use raises a clear error; the widget logic itself is
complete and activates when PyGObject (GTK 3 or 4) is installed.
"""

__all__ = ['gtk_available', 'GtkVideoWidget']

_gtk = None


def _load_gtk():
    global _gtk
    if _gtk is not None:
        return _gtk
    try:
        import gi
        for version in ('4.0', '3.0'):
            try:
                gi.require_version('Gtk', version)
                break
            except ValueError:
                continue
        from gi.repository import GLib, Gdk, GdkPixbuf, Gtk
        _gtk = (Gtk, Gdk, GdkPixbuf, GLib)
        return _gtk
    except ImportError:
        _gtk = False
        return _gtk


def gtk_available():
    return bool(_load_gtk())


def GtkVideoWidget(source, clock, frame_rate, window,
                   pixel_aspect_ratio=40.0 / 33.0, rendering_intent=1.25,
                   on_stall=None, device=None):
    """Create a GTK drawing area displaying *source* driven by *clock*.

    Raises RuntimeError when PyGObject is not installed. Mirrors
    GtkVideoWidget.c: frames arrive from the playback engine's render
    thread and are marshalled onto the GTK main loop (GLib.idle_add —
    the g_timeout_add pattern) before invalidating the surface. The
    engine renders on *device* (None: the card).
    """
    gtk = _load_gtk()
    if not gtk:
        raise RuntimeError('PyGObject (GTK) not available')
    Gtk, Gdk, GdkPixbuf, GLib = gtk

    from canvas_tpu_torch.playback import VideoPlaybackEngine

    class _GtkVideoWidget(Gtk.DrawingArea):
        def __init__(self):
            super().__init__()
            self._pixbuf = None
            if hasattr(self, 'set_draw_func'):       # GTK 4
                self.set_draw_func(self._draw_gtk4)
            else:                                    # GTK 3
                self.connect('draw', self._draw_gtk3)
            self._engine = VideoPlaybackEngine(
                source, clock, frame_rate, window, self._present,
                pixel_aspect_ratio=pixel_aspect_ratio,
                rendering_intent=rendering_intent, on_stall=on_stall,
                device=device)
            w, h = self._engine.display_size()
            self.set_size_request(w, h)
            # Soft mode paints at WIDGET size (widget_gl.c:793-816):
            # viewport-sized device fetches on shrink, like the Qt
            # widget's resizeEvent. GTK 3 signals size-allocate; GTK 4
            # subclasses would override do_size_allocate (the fake and
            # GTK 3 both take the connect path).
            if hasattr(self, 'connect'):
                try:
                    self.connect('size-allocate', self._size_allocate)
                except TypeError:
                    pass

        def _size_allocate(self, _widget, allocation):
            w = getattr(allocation, 'width', 0)
            h = getattr(allocation, 'height', 0)
            if w > 0 and h > 0:
                src_w, src_h = self._engine.display_size()
                if w < src_w or h < src_h:
                    self._engine.set_viewport((w, h))
                else:
                    self._engine.set_viewport(None)

        @property
        def engine(self):
            return self._engine

        def _present(self, frame_index, bgra):
            # bgra (H, W, 4) u8 -> RGB pixbuf; hop onto the main loop
            rgb = bgra[:, :, 2::-1].tobytes()
            height, width = bgra.shape[:2]

            def apply():
                # Pixbuf.new_from_data does NOT copy the buffer — keep
                # the bytes alive for the pixbuf's lifetime.
                self._pixbuf_data = rgb
                self._pixbuf = GdkPixbuf.Pixbuf.new_from_data(
                    rgb, GdkPixbuf.Colorspace.RGB, False, 8,
                    width, height, width * 3)
                self.queue_draw()
                return False

            GLib.idle_add(apply)

        def _draw_common(self, cr):
            if self._pixbuf is not None:
                Gdk.cairo_set_source_pixbuf(cr, self._pixbuf, 0, 0)
                cr.paint()
            else:
                cr.set_source_rgb(0, 0, 0)
                cr.paint()

        def _draw_gtk3(self, _widget, cr):
            self._draw_common(cr)
            return False

        def _draw_gtk4(self, _area, cr, _w, _h):
            self._draw_common(cr)

        def close(self):
            self._engine.stop()

    return _GtkVideoWidget()
