"""Libav-backed source and codec plugins.

Rebuild of the reference's fluggo/editor/plugins/libav/dv.py on top of
the native canvas_av layer (the port's ``canvas_tpu_torch.libav``, over
its own build of ``native/canvas_av.cpp``): a file source plugin that
probes containers and wires decoder connectors, a DV video codec that
runs the port's DV reconstruction (``coded.DVReconstructionFilter``), a
generic video codec (YCbCr planes through
``coded.PlanarReconstructionFilter``, else swscale RGBA linearized on
the device by the ``u8_linearize`` op), and a PCM/generic audio codec.
"""

import fractions

import numpy as np

from canvas_tpu_torch import logging as _logging
from canvas_tpu_torch.basetypes import EMPTY_BOX2I, box2i, box2i_intersect
from canvas_tpu_torch.coded import DVReconstructionFilter
from canvas_tpu_torch.editor import plugins
from canvas_tpu_torch.frames import VideoSource

_log = _logging.getLogger(__name__)

FORMAT_URN_PREFIX = 'urn:canvas:codec-format:'
#: The reference's URN spelling, accepted as an alias
# (fluggo/editor/plugins/libav/dv.py:79)
REF_URN_PREFIX = 'urn:libav:codec-format:'


class _DVError(Exception):
    pass


class LibavSourcePlugin(plugins.SourcePlugin):
    plugin_urn = 'urn:canvas-tpu/plugins:libav'
    # The reference's DV source plugin (dv.py:36) saved projects with
    # this urn and a {path: ...} definition — same shape as ours, so
    # those projects bring their sources online here directly.
    plugin_urn_aliases = ('urn:fluggo.com/canvas/plugins:libav-dv',)
    name = 'Libav Source'
    description = 'Reads media files through the native canvas_av layer'

    @classmethod
    def create_source(cls, name, definition):
        return LibavSource.from_definition(name, definition)

    @classmethod
    def create_source_from_file(cls, name, path):
        source = LibavSource(name, path)
        source.bring_online()
        if not source.offline:
            return source
        return None


class LibavCodecPlugin(plugins.CodecPlugin):
    plugin_urn = 'urn:canvas-tpu/plugins:libav-codecs'
    name = 'Libav Codecs'
    description = 'DV, generic video, and PCM/audio decode via canvas_av'

    @classmethod
    def get_all_codecs(cls):
        return [DVVideoCodec, GenericVideoCodec, GenericAudioCodec]


class _RgbaDecoderSource(VideoSource):
    """Video source over AVVideoDecoder's RGBA output: u8 -> f16 linear
    (rec709->linear scene intent on the 8-bit values)."""

    def __init__(self, decoder, width, height):
        self.decoder = decoder
        self.width = width
        self.height = height

    def _render_f16(self, frame_index, frame):
        from canvas_tpu_torch.ops import color as color_ops
        from canvas_tpu_torch.ops import window as window_ops
        rgba = self.decoder.get_frame_rgba(frame_index, self.width,
                                           self.height)
        if rgba is None:
            frame.current_window = EMPTY_BOX2I
            return
        image_box = box2i(0, 0, self.width - 1, self.height - 1)
        current = box2i_intersect(image_box, frame.full_window)
        if current.empty():
            frame.current_window = EMPTY_BOX2I
            return
        data = np.moveaxis(rgba, -1, 0).astype(np.float32) / 255.0
        data = data.astype(np.float16)
        data = color_ops.transfer_rec709_to_linear_scene(data)
        # alpha stays 1.0 (linearizing 1.0 keeps 1.0)
        frame.data = window_ops.place(data, image_box, frame.full_window,
                                      current)
        frame.current_window = current

    def emit(self, ctx):
        """Batched node: stage the decoder's u8 RGBA (half the bytes of
        f16) and linearize on device (u8 -> /255 -> f16 -> LUT)."""
        from canvas_tpu_torch.ir import Node, tile_window
        from canvas_tpu_torch.libav import stack_frames
        from canvas_tpu_torch.sources import _emit_empty

        image_box = box2i(0, 0, self.width - 1, self.height - 1)
        current = box2i_intersect(image_box, ctx.window)
        if current.empty():
            return _emit_empty(ctx)

        frames_u8 = []
        for f in ctx.frames:
            rgba = self.decoder.get_frame_rgba(int(f), self.width,
                                               self.height)
            if rgba is None:
                rgba = np.zeros((self.height, self.width, 4), np.uint8)
            # Stage the decoder's INTERLEAVED (H, W, 4) layout as-is:
            # the channel-planar transpose happens on the device
            # ('u8_linearize'), since assigning moveaxis views into the
            # stack is a strided copy on the host.
            frames_u8.append(rgba)
        B = len(ctx.frames)

        node = Node('u8_linearize', params={
            'data': stack_frames(frames_u8),
        }, windows=tile_window(current, B))

        sy0 = current.min.y - image_box.min.y
        sy1 = current.max.y - image_box.min.y
        sx0 = current.min.x - image_box.min.x
        sx1 = current.max.x - image_box.min.x
        dy0 = current.min.y - ctx.window.min.y
        dx0 = current.min.x - ctx.window.min.x
        return Node('place',
                    static=(ctx.window.height, ctx.window.width,
                            sy0, sy1, sx0, sx1, dy0, dx0),
                    children=[node], windows=tile_window(current, B))


class DVVideoCodec(plugins.Codec):
    """DV video: native decode + the port's 4:1:1 reconstruction
    (dv.py:71-113)."""

    urn = 'urn:canvas-tpu/codecs:libav-dv'
    urn_aliases = frozenset(['urn:fluggo.com/canvas/codecs:libav-dv-codec'])
    format_urns = frozenset([FORMAT_URN_PREFIX + 'dvvideo',
                             REF_URN_PREFIX + 'dvvideo'])
    stream_type = 'video'
    can_decode = True
    name = 'Libav DV Video'
    default_priority = 1
    plugin = LibavCodecPlugin

    def create_decoder(self, packet_stream, offset, length):
        return DVVideoDecoderStream(packet_stream, offset, length)


class DVVideoDecoderStream(plugins.VideoStream):
    codec = DVVideoCodec

    def __init__(self, packet_stream, offset, length):
        if offset != 0:
            raise NotImplementedError
        self._pktstream = packet_stream
        base_filter = self.get_static_stream()
        video_format = plugins.VideoFormat(
            interlaced=True,
            full_frame=box2i(-8, -1, -8 + 720 - 1, -1 + 480 - 1),
            active_area=box2i(0, -1, 704 - 1, -1 + 480 - 1),
            pixel_aspect_ratio=fractions.Fraction(10, 11),
            white_point='D65',
            frame_rate=fractions.Fraction(30000, 1001))
        plugins.VideoStream.__init__(self, base_filter, video_format,
                                     (0, (length or 1) - 1))

    def get_definition(self):
        return {}

    def get_static_stream(self):
        from canvas_tpu_torch import libav
        decoder = libav.AVVideoDecoder(self._pktstream, 'dvvideo')
        return DVReconstructionFilter(decoder)


class GenericVideoCodec(plugins.Codec):
    """Any libav-decodable video, presented as linear RGBA."""

    urn = 'urn:canvas-tpu/codecs:libav-video'
    format_urns = frozenset()
    accepts_all_formats = True    # fallback for any libav video codec
    stream_type = 'video'
    can_decode = True
    name = 'Libav Video'
    default_priority = -1
    plugin = LibavCodecPlugin

    def create_decoder(self, packet_stream, offset, length):
        return GenericVideoDecoderStream(packet_stream, offset, length)


class GenericVideoDecoderStream(plugins.VideoStream):
    codec = GenericVideoCodec

    def __init__(self, packet_stream, offset, length):
        if offset != 0:
            raise NotImplementedError
        self._pktstream = packet_stream
        from canvas_tpu_torch import libav
        info = libav.AVContainer(packet_stream.filename)
        try:
            desc = info.streams[packet_stream.stream]
            width, height = desc.frame_size
            rate = desc.real_frame_rate or fractions.Fraction(30000, 1001)
            sar = desc.sample_aspect_ratio or fractions.Fraction(1, 1)
        finally:
            info.close()
        base_filter = self.get_static_stream()
        video_format = plugins.VideoFormat(
            full_frame=box2i(0, 0, width - 1, height - 1),
            pixel_aspect_ratio=sar, frame_rate=rate)
        plugins.VideoStream.__init__(self, base_filter, video_format,
                                     (0, (length or 1) - 1))
        self._size = (width, height)

    def get_definition(self):
        return {}

    def get_static_stream(self):
        from canvas_tpu_torch import libav
        from canvas_tpu_torch.coded import PlanarReconstructionFilter
        decoder = libav.AVVideoDecoder(self._pktstream)
        info = libav.AVContainer(self._pktstream.filename)
        try:
            desc = info.streams[self._pktstream.stream]
            width, height = desc.frame_size
        finally:
            info.close()
        # Prefer the planar path: staging YCbCr planes ships ~2.7x
        # fewer host->device bytes than RGBA and reconstruction (chroma
        # upsample + matrix + transfer) runs on device. The matrix
        # follows the stream's colorspace tag (601 for SD tags, else
        # 709); full-range (jpeg/yuvj) and non-planar/10-bit sources
        # fall back to swscale RGBA, which handles their conversion.
        try:
            color_range, colorspace = decoder.color_info()
            if color_range != 'pc' and decoder.get_frame(0) is not None:
                matrix = 'rec601' if colorspace == 'bt601' else 'rec709'
                return PlanarReconstructionFilter(decoder, width=width,
                                                  height=height,
                                                  matrix=matrix)
        except (ValueError, IOError):
            pass
        return _RgbaDecoderSource(decoder, width, height)


class GenericAudioCodec(plugins.Codec):
    """Any libav-decodable audio (PCM, AAC, ...) via swresample
    (dv.py:115-151 generalized)."""

    urn = 'urn:canvas-tpu/codecs:libav-audio'
    urn_aliases = frozenset(['urn:fluggo.com/canvas/codecs:libav-pcm-codec'])
    format_urns = frozenset([FORMAT_URN_PREFIX + 'pcm_s16le',
                             REF_URN_PREFIX + 'pcm_s16le'])
    accepts_all_formats = True    # any audio avcodec can decode
    stream_type = 'audio'
    can_decode = True
    name = 'Libav Audio'
    plugin = LibavCodecPlugin

    def create_decoder(self, packet_stream, offset, length):
        return GenericAudioDecoderStream(packet_stream, offset, length)


class GenericAudioDecoderStream(plugins.AudioStream):
    codec = GenericAudioCodec

    def __init__(self, packet_stream, offset, length):
        if offset != 0:
            raise NotImplementedError
        self._pktstream = packet_stream
        base_filter = self.get_static_stream()
        audio_format = plugins.AudioFormat(
            sample_rate=base_filter.sample_rate,
            channel_assignment=['FrontLeft', 'FrontRight']
            [:base_filter.channels])
        plugins.AudioStream.__init__(self, base_filter, audio_format,
                                     (0, (length or 1) - 1))

    def get_definition(self):
        return {}

    def get_static_stream(self):
        from canvas_tpu_torch import libav
        return libav.AVAudioDecoder(self._pktstream)


class LibavSource(plugins.Source):
    """A probed media file exposing one connector stream per container
    stream (dv.py:155-283)."""

    plugin = LibavSourcePlugin

    def __init__(self, name, path):
        self.path = path
        self._load_alert = None
        self._loaded_definitions = {}
        self._streams = []
        plugins.Source.__init__(self, name)

    def bring_online(self):
        if not self.offline:
            return
        if self._load_alert:
            self.hide_alert(self._load_alert)
            self._load_alert = None

        from canvas_tpu_torch import libav
        try:
            container = libav.AVContainer(self.path)
            try:
                self._streams = []
                for index, desc in enumerate(container.streams):
                    if desc.type == 'video':
                        length = desc.frame_count or self._guess_video_length(
                            desc)
                        stream = self._find_codec(
                            plugins.VideoDecoderConnector, desc, index, 0,
                            length)
                    elif desc.type == 'audio':
                        length = desc.frame_count or self._guess_audio_length(
                            desc)
                        stream = self._find_codec(
                            plugins.AudioDecoderConnector, desc, index, 0,
                            length)
                    else:
                        continue
                    stream.name = str(index)
                    stream.id = index
                    self.follow_alerts(stream)
                    self._streams.append(stream)
            finally:
                container.close()
            self.offline = False
        except Exception as ex:
            self._load_alert = plugins.Alert(
                'Unexpected ' + type(ex).__name__ + ': ' + str(ex),
                icon=plugins.AlertIcon.Error, source=self.name,
                actions=[('Retry', self._retry_load)], exc_info=True)
            self.show_alert(self._load_alert)

    @staticmethod
    def _guess_video_length(desc):
        if desc.duration and desc.time_base and desc.real_frame_rate:
            return int(round(fractions.Fraction(desc.duration) *
                             desc.time_base * desc.real_frame_rate))
        return 1

    @staticmethod
    def _guess_audio_length(desc):
        if desc.duration and desc.time_base and desc.sample_rate:
            return int(round(fractions.Fraction(desc.duration) *
                             desc.time_base * desc.sample_rate))
        return 1

    def _find_codec(self, cls, desc, index, offset, length):
        from canvas_tpu_torch import libav
        format_urn = FORMAT_URN_PREFIX + desc.codec
        demuxer = libav.AVDemuxer(self.path, index)
        loaded = self._loaded_definitions.get(index)
        urn, definition = (loaded['urn'], loaded['definition']) if loaded \
            else (None, None)
        return cls(demuxer, format_urn, offset, length, model_obj=self,
                   codec_urn=urn, definition=definition)

    def _retry_load(self, checked=False):
        self.bring_online()

    @classmethod
    def from_definition(cls, name, definition):
        source = cls(name, definition['path'])
        source._loaded_definitions = definition.get('streams') or {}
        return source

    def get_definition(self):
        streams = {}
        for stream in self._streams:
            if stream.codec:
                streams[stream.id] = {'urn': stream.codec.urn,
                                      'definition': stream.get_definition()}
            elif stream.id in self._loaded_definitions:
                streams[stream.id] = self._loaded_definitions[stream.id]
        return {'path': self.path, 'streams': streams}

    @property
    def file_path(self):
        return self.path

    def get_streams(self):
        if self.offline:
            raise plugins.SourceOfflineError
        return self._streams
