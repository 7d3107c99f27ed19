"""Background render/export job with progress and cancel.

Model of the reference's fluggo/editor/ui/renderprogress.py (:26-94):
the reference runs the muxer on a QThread behind a progress dialog; here
RenderJob runs the port's ``libav.write_video`` export on a worker
thread with progress callbacks and cancellation — dialogs layer on top.
The job renders on its ``device`` (None: the card, raising without one;
``'cpu'``: the kernels' plain versions).
"""

import threading

from canvas_tpu_torch import backend
from canvas_tpu_torch.signal import Signal

__all__ = ['RenderJob']


class RenderJob:
    """Runs a write_video export off the UI thread.

    progress(frames_done, frame_count) fires per batch;
    finished(error) fires once — None on success/cancel, else the
    exception. *kw* goes to write_video.
    """

    def __init__(self, filename, video_source, audio_source, start_frame,
                 end_frame, device=None, **kw):
        self.filename = filename
        self.video_source = video_source
        self.audio_source = audio_source
        self.start_frame = int(start_frame)
        self.end_frame = int(end_frame)
        self.kw = kw
        self.device = backend.resolve_device(device)
        self.progress = Signal()
        self.finished = Signal()
        self._cancel = threading.Event()
        self._thread = None

    def start(self):
        backend.ensure_initialized()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='canvas-render')
        self._thread.start()
        return self

    def cancel(self):
        self._cancel.set()

    @property
    def cancelled(self):
        return self._cancel.is_set()

    def join(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)

    def _run(self):
        from canvas_tpu_torch import libav
        try:
            total = self.end_frame - self.start_frame

            def on_progress(done):
                self.progress(done, total)
                return not self._cancel.is_set()

            libav.write_video(self.filename, self.video_source,
                              self.audio_source, self.start_frame,
                              self.end_frame,
                              progress_callback=on_progress,
                              device=self.device, **self.kw)
            self.finished(None)
        except Exception as ex:
            self.finished(ex)
