"""Pure-Python EBML writer and Matroska muxer.

Capability equivalent of the reference's fluggo.media.matroska
(fluggo/media/matroska.py:76-932): an EBML element tree,
the Matroska structures (tracks, clusters, simple blocks, cues, seek
head, tags), and a streaming :class:`MatroskaWriter` with the same
surface — ``write_start`` / ``write_tracks`` / ``write_simple_block`` /
``write_end`` — plus the ``write_audio_pcm_float`` convenience used by
the reference's audio tests.

Implementation is freshly designed around byte-exact *encoders* plus a
position-tracking writer: elements render to bytes bottom-up; the
streaming writer reserves a Void slot for the top seek head and patches
it (and the segment size and duration) on close. Output is validated in
tests by demuxing with libavformat via canvas_tpu_torch.libav.
"""

import datetime
import math
import struct

__all__ = ['Error', 'ebml', 'EBMLIDs', 'SegmentIDs', 'TrackType',
           'TrackVideo', 'TrackAudio', 'Track', 'TrackList', 'SeekHead',
           'Seek', 'SegmentInfo', 'Cues', 'CuePoint', 'CueTrackPosition',
           'Tags', 'Tag', 'Target', 'SimpleTag', 'Cluster', 'SimpleBlock',
           'MatroskaWriter', 'write_audio_pcm_float']


class Error(Exception):
    pass


_UNKNOWN_SIZE = b'\x01\xff\xff\xff\xff\xff\xff\xff'


def encode_id(element_id):
    """EBML IDs carry their own length marker; emit minimal big-endian."""
    n = max(1, (element_id.bit_length() + 7) // 8)
    return element_id.to_bytes(n, 'big')


def encode_size(value, length=None):
    """EBML VINT size field."""
    if value < 0:
        raise Error('negative size')
    if length is None:
        length = 1
        while value >= (1 << (7 * length)) - 1 and length < 8:
            length += 1
    marker = 1 << (7 * length)
    return (marker | value).to_bytes(length, 'big')


def encode_uint(value):
    n = max(1, (int(value).bit_length() + 7) // 8)
    return int(value).to_bytes(n, 'big')


def encode_int(value):
    value = int(value)
    n = max(1, (value.bit_length() + 8) // 8)
    return value.to_bytes(n, 'big', signed=True)


def timecode(sample, sample_rate, timecode_scale):
    """Sample index -> Matroska timecode units (matroska.py:58-62)."""
    return (sample * 1_000_000_000) // (sample_rate * timecode_scale)


def make_void(size):
    """A Void element filling exactly *size* bytes (matroska.py:64-74)."""
    if size < 2:
        raise Error('void must be >= 2 bytes')
    if size < 10:
        return b'\xec' + encode_size(size - 2, 1) + b'\x00' * (size - 2)
    return b'\xec' + encode_size(size - 9, 8) + b'\x00' * (size - 9)


_EPOCH_2001 = datetime.datetime(2001, 1, 1, tzinfo=datetime.timezone.utc)


class ebml:
    """An EBML element: id + contents (scalar, bytes, or child list).

    Mirrors the reference's tree-building surface (matroska.py:76-151):
    ``add_int``/``add_float``/``add_string``/... append child elements,
    skipping values equal to their schema default.
    """

    def __init__(self, element_id, contents):
        self.element_id = element_id
        self.contents = contents
        self.written_pos = None          # file offset of the element id
        self.written_header_size = None
        self.written_size = None

    # -- child helpers ----------------------------------------------------

    def _add(self, element):
        self.contents.append(element)
        return element

    def add_bool(self, element_id, value, default=None):
        if value is not None and value != default:
            return self._add(ebml(element_id, 1 if value else 0))

    def add_int(self, element_id, value, default=None):
        if value is not None and value != default:
            return self._add(ebml(element_id, int(value)))

    def add_float(self, element_id, value, default=None):
        if value is not None and value != default:
            return self._add(ebml(element_id, _Float32(value)))

    def add_double(self, element_id, value, default=None):
        if value is not None and value != default:
            return self._add(ebml(element_id, float(value)))

    def add_date(self, element_id, value):
        if value is not None:
            if value.tzinfo is None:
                value = value.replace(tzinfo=datetime.timezone.utc)
            ns = int((value - _EPOCH_2001).total_seconds() * 1e9)
            return self._add(ebml(element_id, _Date(ns)))

    def add_string(self, element_id, value, default=None):
        if value is not None and value != default:
            return self._add(ebml(element_id, value.encode('ascii')))

    def add_utf8(self, element_id, value, default=None):
        if value is not None and value != default:
            return self._add(ebml(element_id, value.encode('utf-8')))

    def add_binary(self, element_id, value):
        if value is not None:
            return self._add(ebml(element_id, bytes(value)))

    # -- encoding ---------------------------------------------------------

    def encode_body(self):
        c = self.contents
        if isinstance(c, ebml):
            return c.encode()
        if isinstance(c, (bytes, bytearray, memoryview)):
            return bytes(c)
        if isinstance(c, list):
            return b''.join(child.encode() for child in c)
        if isinstance(c, bool):
            return encode_uint(1 if c else 0)
        if isinstance(c, _Float32):
            return struct.pack('>f', float(c))
        if isinstance(c, _Date):
            return int(c).to_bytes(8, 'big', signed=True)
        if isinstance(c, float):
            return struct.pack('>d', c)
        if isinstance(c, int):
            return encode_uint(c) if c >= 0 else encode_int(c)
        if isinstance(c, str):
            return c.encode('utf-8')
        raise Error('cannot encode contents of type %r' % type(c))

    def encode(self, size_length=None):
        body = self.encode_body()
        return (encode_id(self.element_id) +
                encode_size(len(body), size_length) + body)

    def write(self, fd):
        """Write (or rewrite in place if previously written)."""
        body = self.encode_body()
        data = (encode_id(self.element_id) + encode_size(len(body))
                + body)
        if self.written_pos is not None:
            want = ((self.written_size or 0)
                    + (self.written_header_size or 0))
            if self.written_size is not None and len(data) != want:
                # minimal-length encodings: a patched value that
                # re-encodes shorter/longer would silently overwrite
                # the neighboring element's bytes
                raise Error(
                    'in-place rewrite changed element size %d -> %d'
                    % (want, len(data)))
            saved = fd.tell()
            fd.seek(self.written_pos)
            fd.write(data)
            fd.seek(saved)
        else:
            self.written_pos = fd.tell()
            self.written_header_size = len(data) - len(body)
            self.written_size = len(body)
            fd.write(data)


class _Float32(float):
    """Marker type: encode as 4-byte float."""


class _Date(int):
    """Marker type: encode as 8-byte signed date."""


# -- ID registries (Matroska spec) -------------------------------------------

class EBMLIDs:
    Element = 0x1A45DFA3
    EBMLVersion = 0x4286
    EBMLReadVersion = 0x42F7
    EBMLMaxIDLength = 0x42F2
    EBMLMaxSizeLength = 0x42F3
    DocType = 0x4282
    DocTypeVersion = 0x4287
    DocTypeReadVersion = 0x4285


class SegmentIDs:
    Element = 0x18538067
    SeekHead = 0x114D9B74
    Info = 0x1549A966
    Tracks = 0x1654AE6B
    Cluster = 0x1F43B675
    Cues = 0x1C53BB6B
    Tags = 0x1254C367


class TrackType:
    VIDEO = 0x01
    AUDIO = 0x02
    COMPLEX = 0x03
    LOGO = 0x10
    SUBTITLE = 0x11
    BUTTONS = 0x12
    CONTROL = 0x20


class DisplayUnit:
    PIXELS = 0
    CENTIMETERS = 1
    INCHES = 2
    DISPLAY_ASPECT_RATIO = 3


class TrackVideo(ebml):
    Element = 0xE0
    FlagInterlaced = 0x9A
    PixelWidth = 0xB0
    PixelHeight = 0xBA
    PixelCropBottom = 0x54AA
    PixelCropTop = 0x54BB
    PixelCropLeft = 0x54CC
    PixelCropRight = 0x54DD
    DisplayWidth = 0x54B0
    DisplayHeight = 0x54BA
    DisplayUnit = 0x54B2

    def __init__(self, pixel_width, pixel_height, pixel_crop=None,
                 interlaced=False, display_width=None, display_height=None,
                 display_unit=None):
        ebml.__init__(self, self.Element, [])
        self.add_bool(self.FlagInterlaced, interlaced, default=False)
        self.add_int(self.PixelWidth, pixel_width)
        self.add_int(self.PixelHeight, pixel_height)
        if pixel_crop is not None:
            left, top, right, bottom = pixel_crop
            self.add_int(self.PixelCropLeft, left, default=0)
            self.add_int(self.PixelCropTop, top, default=0)
            self.add_int(self.PixelCropRight, right, default=0)
            self.add_int(self.PixelCropBottom, bottom, default=0)
        self.add_int(self.DisplayWidth, display_width)
        self.add_int(self.DisplayHeight, display_height)
        self.add_int(self.DisplayUnit, display_unit, default=0)


class TrackAudio(ebml):
    Element = 0xE1
    SamplingFrequency = 0xB5
    OutputSamplingFrequency = 0x78B5
    Channels = 0x9F
    BitDepth = 0x6264

    def __init__(self, sample_rate=8000.0, output_sample_rate=None,
                 channels=1, bit_depth=None):
        ebml.__init__(self, self.Element, [])
        self.add_double(self.SamplingFrequency, float(sample_rate))
        self.add_double(self.OutputSamplingFrequency, output_sample_rate)
        self.add_int(self.Channels, channels, default=1)
        self.add_int(self.BitDepth, bit_depth)


class Track(ebml):
    Element = 0xAE
    TrackNumber = 0xD7
    TrackUID = 0x73C5
    TrackType_ = 0x83
    FlagEnabled = 0xB9
    FlagDefault = 0x88
    FlagForced = 0x55AA
    FlagLacing = 0x9C
    MinCache = 0x6DE7
    MaxCache = 0x6DF8
    DefaultDuration = 0x23E383
    Name = 0x536E
    Language = 0x22B59C
    CodecID = 0x86
    CodecPrivate = 0x63A2
    CodecName = 0x258688

    def __init__(self, number, uid, type_, codec_id, enabled=True,
                 default=True, forced=False, lacing=True,
                 default_duration=None, name=None, language=None,
                 codec_private=None, codec_name=None, video=None,
                 audio=None, min_cache=0, max_cache=None,
                 default_duration_ns=None):
        # default_duration_ns / min_cache / max_cache are the
        # reference's kwarg names (fluggo/media/matroska.py:446-448) —
        # accepted so its scripts run unchanged. DefaultDuration IS in
        # ns in Matroska, so the two duration spellings are synonyms;
        # min/max_cache map to the MinCache/MaxCache elements.
        if default_duration_ns is not None:
            if default_duration is not None:
                raise TypeError('pass only one of default_duration / '
                                'default_duration_ns')
            default_duration = default_duration_ns
        ebml.__init__(self, self.Element, [])
        self.number = number
        self.type_ = type_
        self.add_int(self.TrackNumber, number)
        self.add_int(self.TrackUID, uid)
        self.add_int(self.TrackType_, type_)
        self.add_bool(self.FlagEnabled, enabled, default=True)
        self.add_bool(self.FlagDefault, default, default=True)
        self.add_bool(self.FlagForced, forced, default=False)
        self.add_bool(self.FlagLacing, lacing, default=True)
        if min_cache:
            self.add_int(self.MinCache, min_cache)
        if max_cache is not None:
            self.add_int(self.MaxCache, max_cache)
        self.add_int(self.DefaultDuration, default_duration)
        self.add_utf8(self.Name, name)
        self.add_string(self.Language, language, default='eng')
        self.add_string(self.CodecID, codec_id)
        self.add_binary(self.CodecPrivate, codec_private)
        self.add_utf8(self.CodecName, codec_name)
        if video is not None:
            self.contents.append(video)
        if audio is not None:
            self.contents.append(audio)


class TrackList(ebml):
    Element = SegmentIDs.Tracks

    def __init__(self, tracks):
        ebml.__init__(self, self.Element, list(tracks))


class Segment(ebml):
    """The segment: written with unknown size, patched on close."""

    Element = SegmentIDs.Element

    def __init__(self):
        ebml.__init__(self, self.Element, [])

    def write(self, fd):
        self.written_pos = fd.tell()
        fd.write(encode_id(self.Element))
        fd.write(_UNKNOWN_SIZE)
        self.written_header_size = fd.tell() - self.written_pos
        self.written_size = 0

    def write_close(self, fd):
        end = fd.tell()
        size = end - (self.written_pos + self.written_header_size)
        fd.seek(self.written_pos + len(encode_id(self.Element)))
        fd.write(encode_size(size, 8))
        fd.seek(end)


class Seek(ebml):
    Element = 0x4DBB
    SeekID = 0x53AB
    SeekPosition = 0x53AC

    def __init__(self, element_id, position):
        ebml.__init__(self, self.Element, [])
        self.add_binary(self.SeekID, encode_id(element_id))
        self.add_int(self.SeekPosition, position)

    @classmethod
    def from_element(cls, segment, element):
        return cls(element.element_id,
                   element.written_pos -
                   (segment.written_pos + segment.written_header_size))


class SeekHead(ebml):
    Element = SegmentIDs.SeekHead

    def __init__(self, entries, max_count=None):
        ebml.__init__(self, self.Element, list(entries))
        self.max_count = max_count
        self._reserved = None

    def reserve(self, fd):
        """Write a Void placeholder big enough for max_count entries."""
        per_entry = 24
        self._reserved = 12 + (self.max_count or 5) * per_entry
        self.written_pos = fd.tell()
        fd.write(make_void(self._reserved))

    def write(self, fd):
        if self._reserved is None:
            ebml.write(self, fd)
            return
        data = self.encode()
        if len(data) > self._reserved:
            raise Error('seek head overflows reservation')
        saved = fd.tell()
        fd.seek(self.written_pos)
        fd.write(data)
        pad = self._reserved - len(data)
        if pad >= 2:
            fd.write(make_void(pad))
        elif pad == 1:
            raise Error('cannot pad a single byte')
        fd.seek(saved)


class SegmentInfo(ebml):
    Element = SegmentIDs.Info
    TimecodeScale = 0x2AD7B1
    Duration = 0x4489
    DateUTC = 0x4461
    Title = 0x7BA9
    MuxingApp = 0x4D80
    WritingApp = 0x5741

    def __init__(self, writing_app, muxing_app='Canvas-TPU MatroskaWriter',
                 duration=None, date_utc=None, title=None,
                 timecode_scale=1000000):
        ebml.__init__(self, self.Element, [])
        self.add_int(self.TimecodeScale, timecode_scale,
                     default=None)
        self.duration_element = None
        if duration is not None:
            self.duration_element = self._add(
                ebml(self.Duration, float(duration)))
        self.add_date(self.DateUTC, date_utc)
        self.add_utf8(self.Title, title)
        self.add_utf8(self.MuxingApp, muxing_app)
        self.add_utf8(self.WritingApp, writing_app)


class Cues(ebml):
    Element = SegmentIDs.Cues

    def __init__(self, cue_points=None):
        ebml.__init__(self, self.Element, list(cue_points or []))


class CuePoint(ebml):
    Element = 0xBB
    CueTime = 0xB3

    CueDuration = 0xB2

    def __init__(self, time, track_positions, duration=None):
        if time < 0:
            raise Error('negative cue time %d (unsigned in Matroska)'
                        % time)
        ebml.__init__(self, self.Element, [])
        self.add_int(self.CueTime, time)
        # duration was accepted and silently discarded; emit the
        # optional CueDuration element when given
        if duration is not None:
            self.add_int(self.CueDuration, int(duration))
        self.contents.extend(track_positions)


class CueTrackPosition(ebml):
    Element = 0xB7
    CueTrack = 0xF7
    CueClusterPosition = 0xF1
    CueRelativePosition = 0xF0
    CueBlockNumber = 0x5378

    def __init__(self, track, cluster_position, relative_position=None,
                 block_number=None):
        ebml.__init__(self, self.Element, [])
        self.add_int(self.CueTrack, track)
        self.add_int(self.CueClusterPosition, cluster_position)
        self.add_int(self.CueRelativePosition, relative_position)
        self.add_int(self.CueBlockNumber, block_number, default=1)


class VideoTargetTypeValue:
    COLLECTION = 70
    SEASON = 60
    MOVIE = 50
    PART = 40
    CHAPTER = 30
    SCENE = 20
    SHOT = 10


class AudioTargetTypeValue:
    COLLECTION = 70
    EDITION = 60
    ALBUM = 50
    PART = 40
    TRACK = 30
    MOVEMENT = 20


class Tags(ebml):
    Element = SegmentIDs.Tags

    def __init__(self, tags=None):
        ebml.__init__(self, self.Element, list(tags or []))


class Tag(ebml):
    Element = 0x7373

    def __init__(self, targets, tags):
        ebml.__init__(self, self.Element, [])
        self.contents.extend(targets)
        self.contents.extend(tags)


class Target(ebml):
    Element = 0x63C0
    TargetTypeValue = 0x68CA
    TargetType = 0x63CA
    TagTrackUID = 0x63C5
    TagEditionUID = 0x63C9
    TagChapterUID = 0x63C4
    TagAttachmentUID = 0x63C6

    def __init__(self, target_type, target_type_value=None, track_uid=None,
                 edition_uid=None, chapter_uid=None, attachment_uid=None):
        ebml.__init__(self, self.Element, [])
        self.add_int(self.TargetTypeValue, target_type_value, default=50)
        self.add_string(self.TargetType, target_type)
        self.add_int(self.TagTrackUID, track_uid, default=0)
        self.add_int(self.TagEditionUID, edition_uid, default=0)
        self.add_int(self.TagChapterUID, chapter_uid, default=0)
        self.add_int(self.TagAttachmentUID, attachment_uid, default=0)


class SimpleTag(ebml):
    Element = 0x67C8
    TagName = 0x45A3
    TagLanguage = 0x447A
    TagDefault = 0x4484
    TagString = 0x4487
    TagBinary = 0x4485

    def __init__(self, name, value, language=None, is_default_language=None):
        ebml.__init__(self, self.Element, [])
        self.add_utf8(self.TagName, name)
        self.add_string(self.TagLanguage, language, default='und')
        self.add_bool(self.TagDefault, is_default_language, default=True)
        if isinstance(value, str):
            self.add_utf8(self.TagString, value)
        else:
            self.add_binary(self.TagBinary, value)


class Cluster(ebml):
    Element = SegmentIDs.Cluster
    Timecode = 0xE7

    def __init__(self, timecode):
        if timecode < 0:
            # Matroska Cluster Timecode is UNSIGNED: a negative pts
            # would encode as a signed int a demuxer reads as a huge
            # positive timecode — fail loudly instead of writing a
            # file with garbage timestamps (shift the stream so
            # presentation starts at >= 0)
            raise Error('negative cluster timecode %d (unsigned in '
                        'Matroska; shift the stream start)' % timecode)
        ebml.__init__(self, self.Element, [])
        self.add_int(self.Timecode, timecode)


class SimpleBlock(ebml):
    Element = 0xA3

    def __init__(self, track, absolute_pts, relative_pts, data,
                 keyframe=True, invisible=False, discardable=False):
        contents = bytearray()
        contents.extend(encode_size(track))
        contents.extend(relative_pts.to_bytes(2, 'big', signed=True))
        contents.append((0x80 if keyframe else 0) |
                        (0x08 if invisible else 0) |
                        (0x01 if discardable else 0))
        contents.extend(data)
        ebml.__init__(self, self.Element, bytes(contents))
        self.track = track
        self.keyframe = keyframe
        self.absolute_pts = absolute_pts


class MatroskaWriter:
    """Streaming Matroska writer (matroska.py:752-871)."""

    def __init__(self, fd):
        self.fd = fd
        self.segment = None
        self.segment_info = None
        self.top_seek_head = None
        self.max_cluster_size = 5 * 1024 * 1024
        self.cluster = None
        self.cluster_size = 0
        self.cluster_time = 0
        self.video_tracks = set()
        self.cues = None
        self.tags = None

    def write_start(self, *args, **kw):
        header = ebml(EBMLIDs.Element, [
            ebml(EBMLIDs.EBMLVersion, 1),
            ebml(EBMLIDs.EBMLReadVersion, 1),
            ebml(EBMLIDs.EBMLMaxIDLength, 4),
            ebml(EBMLIDs.EBMLMaxSizeLength, 8),
            ebml(EBMLIDs.DocType, 'matroska'),
            ebml(EBMLIDs.DocTypeVersion, 2),
            ebml(EBMLIDs.DocTypeReadVersion, 2)])
        header.write(self.fd)

        self.segment = Segment()
        self.segment.write(self.fd)

        self.top_seek_head = SeekHead([], max_count=5)
        self.top_seek_head.reserve(self.fd)

        self.segment_info = SegmentInfo(*args, **kw)
        self.segment_info.write(self.fd)
        self.top_seek_head.contents.append(
            Seek.from_element(self.segment, self.segment_info))

        self.cues = Cues()
        self.tags = Tags()

    def add_tag(self, tag):
        self.tags.contents.append(tag)

    def write_tracks(self, tracks):
        track_list = TrackList(tracks)
        track_list.write(self.fd)
        self.video_tracks = {t.number for t in track_list.contents
                             if t.type_ == TrackType.VIDEO}
        self.top_seek_head.contents.append(
            Seek.from_element(self.segment, track_list))

    def write_simple_block(self, track, pts, data, keyframe=True,
                           invisible=False, discardable=False):
        if self.cluster and (abs(pts - self.cluster_time) > 32767 or
                             self.cluster_size > self.max_cluster_size):
            self.finish_cluster()
        if not self.cluster:
            self.cluster_time = pts
            self.cluster = Cluster(pts)
        self.cluster.contents.append(SimpleBlock(
            track, pts, pts - self.cluster_time, data, keyframe=keyframe,
            invisible=invisible, discardable=discardable))
        self.cluster_size += len(data)

    def finish_cluster(self):
        if not self.cluster:
            return
        self.cluster.write(self.fd)
        for block in self.cluster.contents:
            if not isinstance(block, SimpleBlock):
                continue
            if block.keyframe and block.track in self.video_tracks:
                pos = self.cluster.written_pos - (
                    self.segment.written_pos + self.segment.written_header_size)
                self.cues.contents.append(CuePoint(
                    block.absolute_pts,
                    [CueTrackPosition(block.track, pos)]))
        self.cluster = None
        self.cluster_size = 0

    def write_end(self, duration=None):
        self.finish_cluster()

        if self.cues.contents:
            # Matroska requires >= 1 CuePoint inside Cues; audio-only
            # files generate none, and strict validators reject an
            # empty Cues element
            self.cues.write(self.fd)
            self.top_seek_head.contents.append(
                Seek.from_element(self.segment, self.cues))

        if self.tags.contents:
            self.tags.write(self.fd)
            self.top_seek_head.contents.append(
                Seek.from_element(self.segment, self.tags))

        self.top_seek_head.write(self.fd)

        if duration is not None:
            if self.segment_info.duration_element:
                self.segment_info.duration_element.contents = \
                    float(duration)
                self.segment_info.duration_element.write(self.fd)
            else:
                raise Error(
                    'write_end(duration=...) needs a duration '
                    'placeholder: pass duration= to write_start '
                    '(the element is patched in place)')

        self.segment.write_close(self.fd)


def write_audio_pcm_float(filename, source, min_sample, max_sample,
                          sample_rate, channels,
                          writing_app='Canvas-TPU audio writer'):
    """Raw float PCM audio Matroska from an audio source
    (matroska.py:873-932)."""
    import numpy as np

    from canvas_tpu_torch import backend

    with open(filename, 'wb') as fd:
        writer = MatroskaWriter(fd)
        ns = 1_000_000_000
        timescale = math.floor(ns / sample_rate)
        writer.write_start(writing_app=writing_app, duration=0.0,
                           timecode_scale=timescale)
        writer.write_tracks([Track(
            number=1, uid=1, type_=TrackType.AUDIO,
            codec_id='A_PCM/FLOAT/IEEE', lacing=False,
            audio=TrackAudio(sample_rate, channels=channels, bit_depth=32))])

        last_pts = 0
        samples_per_block = 1024
        cursor = min_sample
        while cursor <= max_sample:
            hi = min(cursor + samples_per_block - 1, max_sample)
            frame = source.get_frame(cursor, hi, channels)
            data = np.zeros((hi - cursor + 1, channels), np.float32)
            if not frame.empty:
                lo = max(frame.current_min_sample, cursor)
                top = min(frame.current_max_sample, hi)
                if top >= lo:
                    arr = backend.asnumpy(frame.data).astype(
                        np.float32, copy=False)
                    data[lo - cursor:top - cursor + 1] = arr[
                        lo - frame.full_min_sample:
                        top - frame.full_min_sample + 1]
            abs_tc = timecode(cursor, sample_rate, timescale)
            writer.write_simple_block(
                1, abs_tc, data.astype('<f4').tobytes(), keyframe=True)
            last_pts = timecode(hi + 1, sample_rate, timescale)
            cursor += samples_per_block
        writer.write_end(duration=float(last_pts))


def write_interleaved_blocks(writer, streams):
    """Pull packets from several encoders and write SimpleBlocks in
    presentation order (the DTS-ordered interleave the reference's
    muxers do, AVMuxer.c:232-245; writing whole tracks back-to-back
    makes cluster timecodes jump backwards and desyncs players).

    ``streams`` is a list of ``(track_number, next_packet, to_ms,
    is_keyframe)`` where ``next_packet()`` returns the next packet or
    None at end, ``to_ms(packet)`` its absolute timecode in writer
    units, and ``is_keyframe(packet)`` its key flag. Returns
    {track_number: packet_count}.
    """
    pending = []
    counts = {}
    for (num, next_packet, to_ms, is_kf) in streams:
        counts[num] = 0
        packet = next_packet()
        if packet is not None:
            pending.append([to_ms(packet), num, packet, next_packet,
                            to_ms, is_kf])
    while pending:
        pending.sort(key=lambda e: e[0])
        ms, num, packet, next_packet, to_ms, is_kf = pending.pop(0)
        writer.write_simple_block(num, int(ms), packet.data,
                                  keyframe=bool(is_kf(packet)))
        counts[num] += 1
        nxt = next_packet()
        if nxt is not None:
            pending.append([to_ms(nxt), num, nxt, next_packet, to_ms,
                            is_kf])
    return counts
