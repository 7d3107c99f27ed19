"""Tkinter video widget shim (stdlib toolkit).

Same role as the Qt/GTK video widgets (reference:
src/qt/VideoWidget.cpp, src/gtk/GtkVideoWidget.c): a
paint surface over the toolkit-independent playback engine
(canvas_tpu_torch.playback), which renders on the widget's ``device``
(None: the card). Unlike Qt/GTK, ``tkinter`` ships with CPython — on any
machine with a display this is a ZERO-dependency way to see video, no
binding install needed.

Frames arrive on the engine's render thread as BGRA u8; Tk is strictly
single-threaded, so presentation marshals through a queue drained by an
``after()`` poll on the Tk main loop (the Tk analogue of the Qt shim's
signal emission). Blits use ``tkinter.PhotoImage`` fed binary PPM —
built with numpy only, no PIL.
"""

import queue

import numpy as np

__all__ = ['tk_available', 'VideoWidget', 'play_window', 'bgra_to_ppm']


def tk_available():
    """True when tkinter imports AND a display can actually be opened
    (a headless box imports tkinter fine but Tk() raises)."""
    try:
        import tkinter
    except ImportError:
        return False
    try:
        root = tkinter.Tk()
    except tkinter.TclError:
        return False
    root.destroy()
    return True


def bgra_to_ppm(bgra):
    """Binary P6 PPM bytes from an (H, W, 4) BGRA u8 array — the wire
    format tkinter.PhotoImage accepts without PIL. Alpha drops (the
    playback engine already composited against black)."""
    h, w = bgra.shape[:2]
    rgb = np.ascontiguousarray(bgra[:, :, 2::-1])   # BGR(A) -> RGB
    return b'P6 %d %d 255\n' % (w, h) + rgb.tobytes()


def VideoWidget(source, clock, frame_rate, window, master=None,
                pixel_aspect_ratio=40.0 / 33.0, rendering_intent=1.25,
                on_stall=None, poll_ms=15, device=None):
    """Create a Tk canvas that displays *source* driven by *clock*.

    Mirrors editor.ui.qt.VideoWidget: returns a ``tkinter.Canvas``
    subclass with an ``engine`` property; raises RuntimeError when no
    display is reachable. Resizing below source size routes through
    ``engine.set_viewport`` so display frames resample on device and
    only viewport bytes cross the host link. The engine renders on
    *device* (None: the card).
    """
    import tkinter

    from canvas_tpu_torch.playback import VideoPlaybackEngine

    class _VideoWidget(tkinter.Canvas):
        def __init__(self, master=None):
            super().__init__(master, background='black',
                             highlightthickness=0)
            self._queue = queue.Queue(maxsize=2)
            self._photo = None          # keep a ref: Tk doesn't
            self._image_id = None
            self._after_id = None
            self._engine = VideoPlaybackEngine(
                source, clock, frame_rate, window, self._present,
                pixel_aspect_ratio=pixel_aspect_ratio,
                rendering_intent=rendering_intent, on_stall=on_stall,
                device=device)
            w, h = self._engine.display_size()
            self.configure(width=w, height=h)
            self.bind('<Configure>', self._on_resize)
            self.bind('<Destroy>', self._on_destroy)
            self._poll()

        @property
        def engine(self):
            return self._engine

        # -- render thread side --------------------------------------
        def _present(self, frame_index, bgra):
            # Tk objects must not be touched here; hand the newest
            # frame to the main loop, dropping stale ones under load.
            try:
                self._queue.put_nowait(bgra)
            except queue.Full:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                try:
                    self._queue.put_nowait(bgra)
                except queue.Full:
                    pass

        # -- Tk main loop side ---------------------------------------
        def _poll(self):
            bgra = None
            try:
                while True:
                    bgra = self._queue.get_nowait()
            except queue.Empty:
                pass
            if bgra is not None:
                import tkinter
                self._photo = tkinter.PhotoImage(data=bgra_to_ppm(bgra))
                if self._image_id is None:
                    self._image_id = self.create_image(
                        0, 0, anchor='nw', image=self._photo)
                else:
                    self.itemconfigure(self._image_id, image=self._photo)
            self._after_id = self.after(poll_ms, self._poll)

        def _on_resize(self, event):
            w, h = event.width, event.height
            if w > 0 and h > 0:
                src_w, src_h = self._engine.display_size()
                if w < src_w or h < src_h:
                    self._engine.set_viewport((w, h))
                else:
                    self._engine.set_viewport(None)

        def _on_destroy(self, _event):
            if self._after_id is not None:
                try:
                    self.after_cancel(self._after_id)
                except Exception:
                    pass
                self._after_id = None
            self._engine.stop()

    try:
        return _VideoWidget(master)
    except Exception as exc:
        import tkinter
        if isinstance(exc, tkinter.TclError):
            raise RuntimeError('no display for tkinter: %s' % exc)
        raise


def play_window(source, clock, frame_rate, window, title='canvas_tpu_torch',
                **kwargs):
    """A ready-to-run player window: video widget + play/pause/seek
    transport (the reference's player.glade role, main.py:50-110).
    Returns (root, widget); caller runs ``root.mainloop()``."""
    import tkinter
    from fractions import Fraction

    root = tkinter.Tk()
    root.title(title)
    widget = VideoWidget(source, clock, frame_rate, window, master=root,
                         **kwargs)
    widget.pack(fill='both', expand=True)

    controls = tkinter.Frame(root)
    controls.pack(fill='x')
    playing = tkinter.BooleanVar(value=False)

    def toggle():
        if playing.get():
            clock.stop()
            button.configure(text='Play')
        else:
            clock.play(Fraction(1))
            button.configure(text='Pause')
        playing.set(not playing.get())

    button = tkinter.Button(controls, text='Play', command=toggle)
    button.pack(side='left')

    def on_seek(value):
        frame = int(float(value))
        ns = int(frame * Fraction(1_000_000_000) / Fraction(frame_rate))
        clock.seek(ns)

    scale = tkinter.Scale(controls, from_=0, to=10_000,
                          orient='horizontal', showvalue=False,
                          command=on_seek)
    scale.pack(side='left', fill='x', expand=True)
    return root, widget
