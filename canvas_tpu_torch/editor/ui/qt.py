"""Qt video widget shim (the port's counterpart of
``canvas_tpu.editor.ui.qt``).

Equivalent of the reference's Qt/GTK video widgets
(src/qt/VideoWidget.cpp, src/gtk/GtkVideoWidget.c): a
paint surface over the toolkit-independent playback engine
(canvas_tpu_torch.playback), which renders on the widget's ``device``
(None: the card). Imports lazily and degrades gracefully — without a Qt
binding the module's ``qt_available()`` is False and use raises a clear
error; the widget logic itself is complete and activates when
PyQt5/PyQt6/PySide6 is installed.
"""

__all__ = ['qt_available', 'VideoWidget']

_qt = None


def _load_qt():
    global _qt
    if _qt is not None:
        return _qt
    for name in ('PyQt6', 'PyQt5', 'PySide6'):
        try:
            import importlib
            QtWidgets = importlib.import_module(name + '.QtWidgets')
            QtGui = importlib.import_module(name + '.QtGui')
            QtCore = importlib.import_module(name + '.QtCore')
            _qt = (QtWidgets, QtGui, QtCore)
            return _qt
        except ImportError:
            continue
    _qt = False
    return _qt


def qt_available():
    return bool(_load_qt())


def VideoWidget(source, clock, frame_rate, window, parent=None,
                pixel_aspect_ratio=40.0 / 33.0, rendering_intent=1.25,
                on_stall=None, device=None):
    """Create a Qt widget that displays *source* driven by *clock*,
    rendered on *device* (None: the card).

    Returns a QWidget subclass instance; raises RuntimeError when no Qt
    binding is installed. ``pixel_aspect_ratio`` scales the widget's
    size hint like the reference widget scales its viewport
    (widget_gl.c:755; DV NTSC 4:3 uses 10/11).
    """
    qt = _load_qt()
    if not qt:
        raise RuntimeError('No Qt binding (PyQt5/PyQt6/PySide6) available')
    QtWidgets, QtGui, QtCore = qt

    from canvas_tpu_torch.playback import VideoPlaybackEngine

    class _VideoWidget(QtWidgets.QWidget):
        _frame_ready = QtCore.pyqtSignal() if hasattr(QtCore, 'pyqtSignal') \
            else QtCore.Signal()

        def __init__(self, parent=None):
            super().__init__(parent)
            self._image = None
            self._frame_ready.connect(self.update)
            self._engine = VideoPlaybackEngine(
                source, clock, frame_rate, window, self._present,
                pixel_aspect_ratio=pixel_aspect_ratio,
                rendering_intent=rendering_intent, on_stall=on_stall,
                device=device)

        @property
        def engine(self):
            return self._engine

        def sizeHint(self):
            w, h = self._engine.display_size()
            return QtCore.QSize(w, h)

        def _present(self, frame_index, bgra):
            height, width = bgra.shape[:2]
            # QImage does NOT copy or retain this buffer — keep the
            # bytes alive for the image's lifetime.
            self._image_data = bgra.tobytes()
            self._image = QtGui.QImage(
                self._image_data, width, height, width * 4,
                QtGui.QImage.Format.Format_ARGB32)
            self._frame_ready.emit()

        def paintEvent(self, event):
            painter = QtGui.QPainter(self)
            if self._image is not None:
                painter.drawImage(self.rect(), self._image)
            else:
                painter.fillRect(self.rect(), QtCore.Qt.GlobalColor.black)
            painter.end()

        def resizeEvent(self, event):
            # Soft mode paints at WIDGET size (widget_gl.c:793-816):
            # tell the engine so display frames resample on device and
            # only viewport bytes cross the host link. set_viewport
            # clamps each axis to the source size and no-ops on
            # repeats, so driving it straight from resize is safe.
            w = self.width()
            h = self.height()
            if w > 0 and h > 0:
                src_w, src_h = self._engine.display_size()
                if w < src_w or h < src_h:
                    self._engine.set_viewport((w, h))
                else:
                    self._engine.set_viewport(None)
            super().resizeEvent(event)

        def closeEvent(self, event):
            self._engine.stop()
            super().closeEvent(event)

    return _VideoWidget(parent)
