"""Headless playback demo (the counterpart of ``scripts/play_demo.py``):
media file -> decode -> (DV reconstruction + 2:3 pulldown removal) ->
workspace -> clock-driven playback engine, presenting frames to a
callback and reporting the rate achieved.

With ``--tk`` (and a display) it opens the tkinter player window instead;
with ``--gtk`` it runs the real GTK 3 toolkit headless on a broadwayd
display (``editor.ui.gtk_ctypes``): open the printed
http://127.0.0.1:<port> URL in a browser to watch. The engine renders on
the card by default (``--device cpu``: the kernels' plain versions on the
host). Decoding needs FFmpeg's development files where the native library
is built.

    python -m canvas_tpu_torch.tools.play_demo [--tk | --gtk] INPUT
        [SECONDS] [--device cpu]
"""

import argparse
import os
import sys
import time
from fractions import Fraction

from canvas_tpu_torch.tools import add_device_argument, on_device


def _source(path):
    """(source, window, frame rate) of the media file *path*."""
    from canvas_tpu_torch import libav, process
    from canvas_tpu_torch.basetypes import box2i

    container = libav.AVContainer(path)
    video = next(s for s in container.streams if s.type == 'video')
    rate = video.real_frame_rate or Fraction(30000, 1001)
    width, height = video.frame_size
    is_dv = video.codec == 'dvvideo'
    container.close()

    decoder = libav.AVVideoDecoder(path)
    if is_dv:
        source = process.Pulldown23RemovalFilter(
            process.DVReconstructionFilter(decoder), 0)
        window = box2i(0, -1, 719, 478)
    else:
        from canvas_tpu_torch.editor.plugins.libav_plugin import \
            _RgbaDecoderSource
        source = _RgbaDecoderSource(decoder, width, height)
        window = box2i(0, 0, width - 1, height - 1)
    return source, window, rate


def _play_tk(workspace, rate, window, title, device):
    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.editor.ui import tkui
    if not tkui.tk_available():
        print('--tk: no display reachable (tkinter.Tk() failed); '
              'running headless instead')
        return False
    root, widget = tkui.play_window(workspace, SystemPresentationClock(),
                                    rate, window, title=title, device=device)
    widget.engine.warm(0)
    root.mainloop()
    return True


def _play_gtk(workspace, rate, window, seconds, device):
    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.editor.ui import gtk_ctypes
    if not gtk_ctypes.broadway_available():
        print('--gtk: broadwayd or GTK 3 libraries missing; '
              'running headless instead')
        return False
    port = 8085 + os.getpid() % 100
    proc, display = gtk_ctypes.start_broadwayd(port=port)
    try:
        clock = SystemPresentationClock()
        widget = gtk_ctypes.GtkCtypesVideoWidget(
            workspace, clock, rate, window, display=display, device=device)
        widget.engine.warm(0)
        print('REAL GTK on broadway: open http://127.0.0.1:%d to watch'
              % port, flush=True)
        clock.play(1)
        t_end = time.time() + seconds
        while time.time() < t_end:
            widget.pump(0.1)
        clock.stop()
        print('painted %d frames through the real toolkit' % widget._painted)
        widget.close()
    finally:
        proc.terminate()
        proc.wait()
    return True


def play_headless(workspace, rate, window, seconds, device):
    """Play *workspace* for *seconds* through the engine; returns the
    (perf_counter time, frame index) of every frame presented."""
    from canvas_tpu_torch.clock import SystemPresentationClock
    from canvas_tpu_torch.playback import VideoPlaybackEngine

    presented = []
    clock = SystemPresentationClock()
    engine = VideoPlaybackEngine(
        workspace, clock, rate, window,
        lambda i, bgra: presented.append((time.perf_counter(), i)),
        device=device)
    try:
        # Warm the whole pipeline before the clock starts: a clock already
        # running skips every frame inside the first renders.
        t0 = time.time()
        engine.warm(0)
        warm_s = time.time() - t0
        if warm_s > 0.5:
            print('warmed pipeline in %.1fs' % warm_s)
        presented.clear()
        clock.play(1)
        time.sleep(seconds)
        clock.stop()
    finally:
        engine.stop(timeout=60)
    return presented


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tk', action='store_true')
    ap.add_argument('--gtk', action='store_true')
    ap.add_argument('path', metavar='INPUT')
    ap.add_argument('seconds', nargs='?', type=float, default=3.0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from canvas_tpu_torch import process

    with on_device(args.device) as device:
        source, window, rate = _source(args.path)
        workspace = process.VideoWorkspace()
        workspace.add(source=source, x=0, length=100000)
        if args.tk and _play_tk(workspace, rate, window, args.path, device):
            return 0
        if args.gtk and _play_gtk(workspace, rate, window, args.seconds,
                                  device):
            return 0
        presented = play_headless(workspace, rate, window, args.seconds,
                                  device)
    if len(presented) > 1:
        span = presented[-1][0] - presented[0][0]
        print('presented %d frames in %.2fs (%.1f fps; target %.2f)' % (
            len(presented), span, (len(presented) - 1) / span, float(rate)))
    else:
        print('presented %d frames' % len(presented))
    return 0


if __name__ == '__main__':
    sys.exit(main())
