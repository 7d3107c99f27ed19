"""The port's public import: the engine surface that ``canvas_tpu_torch``
has ported, in one namespace (the counterpart of
``canvas_tpu/process.py``, itself the reference's ``fluggo.media.process``
module surface, src/process/main.c:331-407)::

    from canvas_tpu_torch import process
    solid = process.SolidColorVideoSource((1, 0, 0, 1))
    frame = solid.get_frame_f32(0, process.box2i(0, 0, 719, 479))

A pull of 16,384 pixels or more runs its pixel ops on the card in the
default ``'auto'`` backend mode (``canvas_tpu_torch.backend``), and raises
without one; ``backend.force_backend('numpy')`` keeps a pull on the
host, ``force_backend('torch', device='cpu')`` runs the torch arms on
the host's cores. Batched rendering on the card is
``canvas_tpu_torch.render.RenderPlanner`` (``render_display`` for one
display frame), and across a mesh of devices
``canvas_tpu_torch.render.render_sharded`` (not re-exported here, as the
JAX package's ``process`` does not); clock-driven playback is
``canvas_tpu_torch.playback.VideoPlaybackEngine`` on the presentation
clocks exported here; background pulls are the ``VideoPullQueue``
exported here; export and decode are ``canvas_tpu_torch.libav``
(``write_video``, ``AVVideoDecoder``).
"""

import time as _time

import torch

from canvas_tpu_torch import NS_PER_SEC, backend
from canvas_tpu_torch.basetypes import v2i, v2f, box2i, box2f, rgba  # noqa: F401
from canvas_tpu_torch.frames import (  # noqa: F401
    RgbaFrameF16, RgbaFrameF32, VideoSource)
from canvas_tpu_torch.framefuncs import (  # noqa: F401
    FrameFunction, LinearFrameFunc, LerpFunc, AnimationFunc, AnimationPoint,
    FrameFuncPassThroughFilter, POINT_HOLD, POINT_LINEAR)
from canvas_tpu_torch.sources import (  # noqa: F401
    EmptyVideoSource, SolidColorVideoSource, VideoPassThroughFilter,
    VideoMixFilter, VideoGainOffsetFilter, VideoScaler,
    VideoColorTransferFilter, VideoSequence, VideoWorkspace,
    WorkspaceItem)
from canvas_tpu_torch.coded import (  # noqa: F401
    CodecPacketSource, CodedImage, CodedImageSource,
    DVReconstructionFilter, DVSubsampleFilter, MPEG2SubsampleFilter,
    PlanarReconstructionFilter, Pulldown23RemovalFilter)
from canvas_tpu_torch.audio import (  # noqa: F401
    AudioFrame, AudioSource, AudioPassThroughFilter, AudioSequence,
    AudioWorkspace)
from canvas_tpu_torch.clock import (  # noqa: F401
    ClockCallbackHandle, PresentationClock, SystemPresentationClock)
from canvas_tpu_torch.pullqueue import (  # noqa: F401
    VideoPullQueue, VideoPullQueueItem)

# The reference exposes separate item types per workspace kind
# (VideoWorkspace.c:274 / AudioWorkspace.c:230); this build shares one.
VideoWorkspaceItem = WorkspaceItem
AudioWorkspaceItem = WorkspaceItem


class Offscreen:
    """GL-era offscreen rendering context (main.c:193-250). The port has
    no GL path: its kernels render offscreen by construction. The name
    exists so that reference scripts import; constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'canvas_tpu_torch has no GL path; the card renders offscreen '
            'by construction')


def check_context_supported():
    """Device-capability check (the reference verifies its GL context,
    src/process/main.c:193-250): whether the port's default device, a
    CUDA card, is usable (``torch.cuda.is_available()``). Without one,
    default-mode pulls of 16,384 pixels or more and every planner built
    without ``device='cpu'`` raise."""
    return torch.cuda.is_available()


def enable_glib_logging(enabled=True):
    """Reference API shim (src/process/main.c:169-329 bridges GLib logs
    into Python logging). The port logs through
    ``canvas_tpu_torch.logging``, so there is nothing to bridge."""
    return None


def _cdiv(a, b):
    """C integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _rate(frame_rate):
    if hasattr(frame_rate, 'numerator'):
        return frame_rate.numerator, frame_rate.denominator
    n, d = frame_rate
    return int(n), int(d)


def get_frame_time(frame_rate, frame):
    """Nanosecond presentation time of *frame* at *frame_rate* (a Fraction
    or (n, d)) — src/cprocess/main.c:22-26 (note the +1ns bias the
    reference applies so times land strictly inside the frame)."""
    n, d = _rate(frame_rate)
    return _cdiv(frame * NS_PER_SEC * d, n) + 1


def get_time_frame(frame_rate, time):
    """Frame index containing nanosecond *time* — src/cprocess/main.c:27-31."""
    n, d = _rate(frame_rate)
    return _cdiv(time * n, NS_PER_SEC * d)


def time_get_frame(source, min_frame, max_frame, data_window=None,
                   force_eager=False):
    """Pull frames [min_frame, max_frame] and return elapsed nanoseconds:
    the reference's built-in micro-benchmark (src/process/main.c:120-167).

    Times the port's production frame-range path under this thread's
    backend mode: when ``backend.use_torch_for`` takes the window and the
    source supports planning, a ``RenderPlanner`` on
    ``backend.eager_device()`` streams the range (its kernels on the
    card), each batch fetched to the host; otherwise the eager per-frame
    pull, each frame's tensor fetched to the host to force completion.
    ``force_eager=True`` times the eager pull regardless.
    """
    if data_window is None:
        data_window = box2i(0, 0, 719, 479)

    shape = (data_window.max.y - data_window.min.y + 1,
             data_window.max.x - data_window.min.x + 1)
    if (not force_eager and backend.use_torch_for(shape)
            and hasattr(source, 'plan_cuts')):
        from canvas_tpu_torch import render
        planner = render.RenderPlanner(source, data_window,
                                       device=backend.eager_device())
        try:
            start = _time.monotonic_ns()
            for (_s, _n, _out) in planner.iter_batches(
                    int(min_frame), int(max_frame) + 1, device_out=False):
                pass                  # the host fetch forces completion
            return _time.monotonic_ns() - start
        finally:
            planner.close()

    start = _time.monotonic_ns()
    for i in range(int(min_frame), int(max_frame) + 1):
        frame = source.get_frame_f16(i, data_window)
        if backend.is_torch_tensor(frame.data):
            backend.to_host(frame.data)   # the host fetch forces completion
    return _time.monotonic_ns() - start
