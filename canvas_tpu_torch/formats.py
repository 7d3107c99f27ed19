"""Stream/container format descriptions.

Port of the reference's fluggo.media.formats
(fluggo/media/formats.py:25-33 — KnownColorPrimaries)
*plus* the StreamFormat/ContainerFormat model its documentation specifies
(docs/sphinx/media/formats.rst) but never implemented:
detected-vs-override property dictionaries where user overrides layer
over probed values.
"""

from canvas_tpu_torch.basetypes import v2f

__all__ = ['KnownColorPrimaries', 'StreamFormat', 'ContainerFormat',
           'ContainerProperty', 'VideoProperty', 'AudioProperty',
           'KnownContainerFormat', 'KnownVideoFormat', 'KnownAudioFormat']


class KnownColorPrimaries:
    """Known RGB primary sets and their xy-coordinates (R, G, B)."""

    AdobeRGB = (v2f(0.6400, 0.3300), v2f(0.2100, 0.7100),
                v2f(0.1500, 0.0600))
    AppleRGB = (v2f(0.6250, 0.3400), v2f(0.2800, 0.5950),
                v2f(0.1550, 0.0700))
    sRGB = (v2f(0.6400, 0.3300), v2f(0.3000, 0.6000), v2f(0.1500, 0.0600))
    Rec709 = sRGB
    SMPTE_C = (v2f(0.630, 0.340), v2f(0.310, 0.595), v2f(0.155, 0.070))


class ContainerProperty:
    STREAM_INDEX = 'stream_index'
    FORMAT = 'format'
    MUXER = 'muxer'


class VideoProperty:
    FORMAT = 'format'
    CODEC = 'codec'
    FRAME_RATE = 'frame_rate'
    FRAME_SIZE = 'frame_size'        # v2i
    SAMPLE_ASPECT_RATIO = 'sample_aspect_ratio'
    INTERLACED = 'interlaced'
    PULLDOWN_TYPE = 'pulldown_type'
    PULLDOWN_PHASE = 'pulldown_phase'
    COLOR_PRIMARIES = 'color_primaries'
    TRANSFER_FUNCTION = 'transfer_function'
    MAX_DATA_WINDOW = 'max_data_window'   # box2i
    WHITE_POINT = 'white_point'


class AudioProperty:
    FORMAT = 'format'
    CODEC = 'codec'
    SAMPLE_RATE = 'sample_rate'
    CHANNELS = 'channels'
    CHANNEL_ASSIGNMENT = 'channel_assignment'


class KnownContainerFormat:
    AVI = 'avi'
    DV = 'dv'
    MATROSKA = 'matroska'


class KnownVideoFormat:
    DV = 'dv'
    MPEG2 = 'mpeg2'
    H264 = 'h264'


class KnownAudioFormat:
    PCM = 'pcm'
    AAC = 'aac'


class StreamFormat:
    """Format of one stream: *detected* properties from probing layered
    under user *override* properties."""

    def __init__(self, type, detected=None, override=None, length=None):
        self.type = type
        self.detected = dict(detected or {})
        self.override = dict(override or {})
        self.length = length

    def get(self, property, default=None):
        if property in self.override:
            return self.override[property]
        return self.detected.get(property, default)

    @property
    def index(self):
        return self.get(ContainerProperty.STREAM_INDEX)

    @property
    def adjusted_length(self):
        return self.length

    def __repr__(self):
        return 'StreamFormat(type={0!r}, index={1!r})'.format(
            self.type, self.index)


class ContainerFormat(StreamFormat):
    """A container: detected/override dicts plus a list of stream
    formats."""

    def __init__(self, detected=None, override=None, streams=None,
                 path=None):
        StreamFormat.__init__(self, 'container', detected, override)
        self.streams = list(streams or [])
        self.path = path

    def get_stream(self, index):
        for stream in self.streams:
            if stream.index == index:
                return stream
        return None

    def __repr__(self):
        return 'ContainerFormat(path={0!r}, streams={1})'.format(
            self.path, len(self.streams))


def probe_container(path):
    """Probe *path* with the native libav layer into a ContainerFormat."""
    from canvas_tpu_torch import libav

    container = libav.AVContainer(path)
    try:
        streams = []
        for i, s in enumerate(container.streams):
            detected = {ContainerProperty.STREAM_INDEX: i}
            if s.type == 'video':
                detected.update({
                    VideoProperty.CODEC: s.codec,
                    VideoProperty.FRAME_RATE: s.real_frame_rate,
                    VideoProperty.FRAME_SIZE: s.frame_size,
                    VideoProperty.SAMPLE_ASPECT_RATIO:
                        s.sample_aspect_ratio,
                })
            elif s.type == 'audio':
                detected.update({
                    AudioProperty.CODEC: s.codec,
                    AudioProperty.SAMPLE_RATE: s.sample_rate,
                    AudioProperty.CHANNELS: s.channels,
                })
            streams.append(StreamFormat(s.type, detected,
                                        length=s.frame_count or None))
        return ContainerFormat(
            detected={ContainerProperty.FORMAT: container.format_name},
            streams=streams, path=path)
    finally:
        container.close()
