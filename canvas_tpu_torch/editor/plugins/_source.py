"""Source plugin layer: sources, formats, live stream wrappers.

Headless rebuild of the reference's fluggo/editor/plugins/_source.py:
SourcePlugin/Source (offline model + alerts, :46-296), VideoFormat/
AudioFormat namedtuples with YAML tags (:298-396; on the editor's own
YAML classes, ``editor.yamlio``), and the live
pass-through VideoStream/AudioStream wrappers (:399-578).
"""

import collections
import fractions

from canvas_tpu_torch import audio as audio_mod
from canvas_tpu_torch import sources as sources_mod
from canvas_tpu_torch.basetypes import box2i, v2f
from canvas_tpu_torch.signal import Signal
from canvas_tpu_torch.editor import yamlio
from canvas_tpu_torch.editor.plugins._base import AlertPublisher, Plugin

__all__ = ['SourceOfflineError', 'KnownIlluminants', 'SourcePlugin',
           'Source', 'VideoFormat', 'AudioFormat', 'VideoStream',
           'AudioStream', 'PULLDOWN_NONE', 'PULLDOWN_23', 'PULLDOWN_2332']

PULLDOWN_NONE = 'None'
PULLDOWN_23 = '2:3'
PULLDOWN_2332 = '2:3:3:2'


class SourceOfflineError(Exception):
    def __init__(self):
        Exception.__init__(self, 'Source is offline.')


class KnownIlluminants:
    """Standard illuminants in xy-space (two-degree observer)."""

    D50 = v2f(0.34567, 0.35850)
    D65 = v2f(0.31271, 0.32902)


class SourcePlugin(Plugin):
    """Base class for a plugin that handles certain source types
    (_source.py:46-67)."""

    @classmethod
    def create_source(cls, name, definition):
        """Return a source from a definition previously produced by
        Source.get_definition()."""
        raise NotImplementedError

    @classmethod
    def create_source_from_file(cls, name, path):
        """Return a new source for *path*, or None if unsupported."""
        return None


class Source(AlertPublisher):
    """An object which produces one or more streams (_source.py:92-296).

    Sources start offline; ``bring_online()`` populates streams and
    metadata. Failures should leave the source offline and publish an
    alert with a retry action.
    """

    def __init__(self, name):
        AlertPublisher.__init__(self)
        self._name = name
        self.offline_changed = Signal()
        self._offline = True

    @property
    def offline(self):
        return self._offline

    @offline.setter
    def offline(self, value):
        value = bool(value)
        if value == self._offline:
            return
        self._offline = value
        self.offline_changed(self)

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        self._name = str(value)

    def bring_online(self):
        self.offline = False

    def take_offline(self):
        self.offline = True

    @property
    def plugin(self):
        return None

    def get_definition(self):
        raise NotImplementedError

    @property
    def file_path(self):
        return None

    def get_streams(self):
        raise NotImplementedError

    def get_default_streams(self):
        streams = self.get_streams()
        video = [s for s in streams if s.stream_type == 'video']
        audio = [s for s in streams if s.stream_type == 'audio']
        return video[0:1] + audio[0:1]

    def get_stream(self, name):
        for stream in self.get_streams():
            if stream.name == name:
                return stream
        raise KeyError(name)

    def get_source_metadata(self):
        return None

    def get_stream_metadata(self, name):
        return None

    def get_thumbnail(self, size):
        raise NotImplementedError


_VideoFormat = collections.namedtuple(
    '_VideoFormat',
    'interlaced pulldown_type pulldown_phase full_frame active_area '
    'pixel_aspect_ratio white_point frame_rate')


class VideoFormat(_VideoFormat):
    """Canvas-relevant video format description (_source.py:300-333)."""

    __slots__ = ()
    format_type = 'video'

    def __new__(cls, interlaced=False, pulldown_type=PULLDOWN_NONE,
                pulldown_phase=0, full_frame=box2i(0, 0, 99, 99),
                active_area=None,
                pixel_aspect_ratio=fractions.Fraction(1, 1),
                white_point='D65',
                frame_rate=fractions.Fraction(1, 1)):
        return _VideoFormat.__new__(
            cls, interlaced, pulldown_type, pulldown_phase, full_frame,
            active_area or full_frame, pixel_aspect_ratio, white_point,
            frame_rate)

    @property
    def white_point_value(self):
        if isinstance(self.white_point, v2f):
            return self.white_point
        return getattr(KnownIlluminants, self.white_point)

    @property
    def thumbnail_box(self):
        return self.active_area


def _VideoFormat_represent(dumper, data):
    mapp = {}
    if data.interlaced:
        mapp['interlaced'] = data.interlaced
    if data.pulldown_type != PULLDOWN_NONE:
        mapp['pulldown_type'] = data.pulldown_type
        if data.pulldown_phase != 0:
            mapp['pulldown_phase'] = data.pulldown_phase
    mapp['full_frame'] = data.full_frame
    if data.active_area != data.full_frame:
        mapp['active_area'] = data.active_area
    if data.pixel_aspect_ratio != fractions.Fraction(1, 1):
        mapp['pixel_aspect_ratio'] = data.pixel_aspect_ratio
    mapp['white_point'] = data.white_point
    mapp['frame_rate'] = data.frame_rate
    return dumper.represent_mapping('!VideoFormat', mapp)


def _VideoFormat_construct(loader, node):
    return VideoFormat(**loader.construct_mapping(node, deep=True))


yamlio.register(VideoFormat, '!VideoFormat', _VideoFormat_represent,
                _VideoFormat_construct)


_AudioFormat = collections.namedtuple('_AudioFormat',
                                      'sample_rate channel_assignment')


class AudioFormat(_AudioFormat):
    __slots__ = ()
    format_type = 'audio'

    def __new__(cls, sample_rate=fractions.Fraction(1, 1),
                channel_assignment=None):
        return _AudioFormat.__new__(cls, fractions.Fraction(sample_rate),
                                    channel_assignment or [])


def _AudioFormat_represent(dumper, data):
    return dumper.represent_mapping('!AudioFormat', {
        'sample_rate': data.sample_rate,
        'channel_assignment': data.channel_assignment})


def _AudioFormat_construct(loader, node):
    return AudioFormat(**loader.construct_mapping(node, deep=True))


yamlio.register(AudioFormat, '!AudioFormat', _AudioFormat_represent,
                _AudioFormat_construct)


class _StreamMixin(AlertPublisher):
    """Shared live-stream behavior for Video/AudioStream: format and
    defined-range bookkeeping plus the base-filter swap. Signals:
    format_changed(stream), frames_updated(stream, start, end),
    range_changed(stream). ONE home for the invalidation-union
    contract so the video and audio paths cannot drift."""

    _default_format = None      # subclasses: VideoFormat / AudioFormat

    def _init_stream(self, format, range, name):
        self._format = format or self._default_format()
        self._defined_range = range
        self.format_changed = Signal()
        self.frames_updated = Signal()
        self.range_changed = Signal()
        self.name = name
        AlertPublisher.__init__(self)

    @property
    def format(self):
        return self._format

    def set_format(self, format):
        if self._format == format:
            return
        self._format = format
        self.format_changed(self)

    @property
    def defined_range(self):
        return self._defined_range

    def set_defined_range(self, defined_range):
        if self._defined_range == defined_range:
            return
        self._defined_range = defined_range
        self.range_changed(self)

    def set_base_filter(self, base_filter, new_range=None):
        old_range = self._defined_range
        if new_range:
            self.set_defined_range(new_range)
        else:
            new_range = old_range
        # Follow the base's own frames_updated (same coordinates — the
        # wrapper is an identity pass-through): content edits inside a
        # nested composition or a live source must surface through
        # every wrapper on the way up for ranged cache invalidation.
        followed = getattr(self, '_followed_base', None)
        if followed is not None:
            followed.frames_updated.disconnect(self._refire_base_frames)
            self._followed_base = None
        if base_filter is not None and hasattr(base_filter,
                                               'frames_updated'):
            base_filter.frames_updated.connect(self._refire_base_frames)
            self._followed_base = base_filter
        self.set_source(base_filter)
        # UNION of old and new ranges (the reference's documented
        # contract; its code takes min() for the end — a bug that was
        # harmless while any signal cleared every cache, but the
        # planner's ranged invalidation would under-invalidate frames
        # the swap added/removed past the shorter range's end).
        start = None if (old_range[0] is None or new_range[0] is None) \
            else min(old_range[0], new_range[0])
        end = None if (old_range[1] is None or new_range[1] is None) \
            else max(old_range[1], new_range[1])
        self.frames_updated(self, start, end)

    def _refire_base_frames(self, *args):
        self.frames_updated(self, args[-2], args[-1])

    def get_static_stream(self):
        raise NotImplementedError


class VideoStream(sources_mod.VideoPassThroughFilter, _StreamMixin):
    """Live video stream wrapper (_source.py:399-492): usable directly as
    a pull source; updates propagate."""

    stream_type = 'video'
    _default_format = staticmethod(lambda: VideoFormat())

    def __init__(self, base_filter=None, format=None, range=(None, None),
                 name=None):
        self._init_stream(format, range, name)
        sources_mod.VideoPassThroughFilter.__init__(self, base_filter)


class AudioStream(audio_mod.AudioPassThroughFilter, _StreamMixin):
    """Live audio stream wrapper (_source.py:494-578)."""

    stream_type = 'audio'
    _default_format = staticmethod(lambda: AudioFormat())

    def __init__(self, base_filter=None, format=None, range=(None, None),
                 name=None):
        self._init_stream(format, range, name)
        audio_mod.AudioPassThroughFilter.__init__(self, base_filter)
