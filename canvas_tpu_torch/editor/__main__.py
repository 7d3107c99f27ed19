"""The port's editor entry point (the counterpart of ``scripts/editor.py``,
the reference's qttest.py role).

Launches the full Qt main window — document tabs with mouse-editable
timelines, video preview, asset/notification docks, transport — when a
Qt binding (PyQt5/PyQt6/PySide6) is installed. The window renders on the
card; ``CANVAS_FORCE_CPU=1`` renders on the CPU instead (the kernels'
plain versions).

Usage: python -m canvas_tpu_torch.editor [PROJECT.yaml]
"""

import os
import sys


def _wire_render_dialog(window, QtWidgets, QtCore):
    """File > Render against a real binding: prompt for a save path,
    run render_space(block=False), and poll job progress into the
    status bar with a GUI-thread timer (RenderJob signals fire on the
    worker thread — Qt widgets must not be touched from there)."""
    state = {'done': 0, 'total': 0, 'error': None, 'job_done': True}

    window.render_progress.connect(
        lambda done, total: state.update(done=done, total=total))

    def on_finished(error):
        state.update(error=error, job_done=True)

    window.render_finished.connect(on_finished)

    timer = QtCore.QTimer(window)
    timer.setInterval(200)

    def tick():
        bar = window.statusBar()
        window.flush_render_alerts()    # GUI thread: safe to touch docks
        if not state['job_done']:
            bar.showMessage('Rendering... %d/%d frames'
                            % (state['done'], state['total']))
            return
        timer.stop()
        if state['error'] is not None:
            bar.showMessage('Render failed: %s' % state['error'], 10000)
        else:
            bar.showMessage('Render complete (%d frames)'
                            % state['done'], 5000)

    timer.timeout.connect(tick)

    def prompt():
        editor = window.current_editor
        if editor is None or not state['job_done']:
            return
        got = QtWidgets.QFileDialog.getSaveFileName(
            window, 'Render', '', 'AVI files (*.avi);;All files (*)')
        path = got[0] if isinstance(got, tuple) else got
        if not path:
            return
        area = editor.space.video_format.active_area
        # job_done flips False before start so a worker that finishes
        # instantly still flips it back True; a synchronous failure
        # (no card, bad path) resets it so the action can't go
        # permanently inert
        state.update(done=0, total=0, error=None, job_done=False)
        try:
            window.render_space(str(path), block=False,
                                frame_size=(area.width, area.height),
                                video_codec='ffv1', format='avi')
        except Exception as ex:
            state.update(error=ex, job_done=True)
        timer.start()

    window.render_requested.connect(prompt)


def main(argv=None):
    """Run the editor; *argv* defaults to ``sys.argv`` (its first entry
    the program name, the second an optional project file)."""
    from canvas_tpu_torch.editor.ui import qt as qt_shim

    argv = sys.argv if argv is None else argv
    if not qt_shim.qt_available():
        print('No Qt binding (PyQt5/PyQt6/PySide6) installed.')
        print('The editor logic still runs headless — see '
              'canvas_tpu_torch.editor.ui.EditorApp and the test suite.')
        return 1

    QtWidgets = qt_shim._load_qt()[0]
    QtCore = qt_shim._load_qt()[2]
    from canvas_tpu_torch.editor.ui import create_main_window

    device = 'cpu' if os.environ.get('CANVAS_FORCE_CPU') else None
    qapp = QtWidgets.QApplication(argv)
    window = create_main_window(device=device)
    _wire_render_dialog(window, QtWidgets, QtCore)
    if len(argv) > 1:
        window.open_project(argv[1])
    window.show()
    try:
        return qapp.exec() if hasattr(qapp, 'exec') else qapp.exec_()
    finally:
        # Deterministic teardown: stop playback engines/clock threads
        # even when the event loop exits abnormally (also what lets
        # headless tests drive main() without leaking threads).
        window.closeEvent(None)


if __name__ == '__main__':
    sys.exit(main())
