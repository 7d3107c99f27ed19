"""The port's public import: the engine surface that ``canvas_tpu_torch``
has ported, in one namespace (the counterpart of
``canvas_tpu/process.py``, itself the reference's ``fluggo.media.process``
module surface, src/process/main.c:331-407)::

    from canvas_tpu_torch import process
    solid = process.SolidColorVideoSource((1, 0, 0, 1))
    frame = solid.get_frame_f32(0, process.box2i(0, 0, 719, 479))

Batched rendering on the card is ``canvas_tpu_torch.render.RenderPlanner``
(``render_display`` for one display frame); clock-driven playback is
``canvas_tpu_torch.playback.VideoPlaybackEngine`` on the presentation
clocks exported here; export and decode are
``canvas_tpu_torch.libav`` (``write_video``, ``AVVideoDecoder``). The
pull queue is not ported yet (ROADMAP.md queue 1).
"""

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

NS_PER_SEC = 1000000000

# The reference exposes separate item types per workspace kind
# (VideoWorkspace.c:274 / AudioWorkspace.c:230); this build shares one.
VideoWorkspaceItem = WorkspaceItem
AudioWorkspaceItem = WorkspaceItem


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
