"""Codec plugin layer: codec base classes and decoder connectors.

Headless rebuild of the reference's fluggo/editor/plugins/_codec.py:
CodecPlugin/Codec (:25-93) and the alert-publishing decoder connectors
(:98-236) that find a codec for a packet stream and degrade gracefully
(blank stream + alert) when none works.
"""

from canvas_tpu_torch import logging as _logging
from canvas_tpu_torch.editor.plugins._base import (Alert, AlertIcon, Plugin,
                                             PluginManager)
from canvas_tpu_torch.editor.plugins._source import AudioStream, VideoStream

_log = _logging.getLogger(__name__)

__all__ = ['CodecPlugin', 'Codec', 'NotConnectedError',
           'VideoDecoderConnector', 'AudioDecoderConnector']


class CodecPlugin(Plugin):
    """Provides encoders/decoders for one or more stream formats
    (_codec.py:25-35)."""

    @classmethod
    def get_all_codecs(cls):
        return []


class Codec:
    """One codec: metadata + encoder/decoder factories (_codec.py:37-93)."""

    default_priority = 0
    plugin = None
    name = None
    format_urns = frozenset()
    urn = None
    #: URNs this codec also answers to (reference projects carry e.g.
    #: 'urn:fluggo.com/canvas/codecs:libav-dv-codec', dv.py:71).
    urn_aliases = frozenset()
    stream_type = None
    can_decode = False
    can_encode = False

    @classmethod
    def get_localized_name(cls):
        return None

    def get_definition(self):
        return {}

    def create_encoder(self, stream, offset, length):
        raise NotImplementedError

    def create_decoder(self, packet_stream, offset, length):
        raise NotImplementedError


class NotConnectedError(Exception):
    pass


class _DecoderConnector:
    """Finds a codec to decode a packet stream, publishing alerts on
    failure (_codec.py:98-226). Mixed into VideoStream/AudioStream."""

    def __init__(self, packet_stream, format_urn, offset, length,
                 model_obj=None, codec_urn=None, definition=None):
        if not packet_stream:
            raise ValueError('packet_stream cannot be None')
        self._pktstream = packet_stream
        self._offset = offset
        self._length = length
        self._start_definition = definition or {}
        self._format_urn = format_urn
        self._codec_urn = codec_urn
        self.model_obj = model_obj
        self.codec = None
        self.decoder = None
        self._error = None
        self.connect()

    def _clear(self):
        self.set_base_filter(None, new_range=(None, None))
        self.set_format(None)

    def get_definition(self):
        if not self.decoder:
            return self._start_definition
        return self.decoder.get_definition()

    def _fail(self, description, exc_info=False):
        self._clear()
        self._error = Alert(description, model_obj=self.model_obj,
                            icon=AlertIcon.Error, exc_info=exc_info)
        self.show_alert(self._error)

    def connect(self):
        try:
            if self.decoder:
                self.unfollow_alerts(self.decoder)
                self.decoder = None
            self.codec = None
            if self._error:
                self.hide_alert(self._error)
                self._error = None

            if self._codec_urn:
                codec_class = PluginManager.get_codec_by_urn(self._codec_urn)
                if not codec_class:
                    self._fail('Could not find codec "' + self._codec_urn +
                               '". Check to see that it is installed and '
                               'enabled.')
                    return
                try:
                    codec = codec_class(**self._start_definition)
                except Exception:
                    self._fail('Error while creating codec instance',
                               exc_info=True)
                    return
                try:
                    self.decoder = codec.create_decoder(
                        self._pktstream, self._offset, self._length)
                    self.codec = codec
                except Exception:
                    self._fail('Error while creating decoder', exc_info=True)
                    return
            else:
                codecs = PluginManager.find_decoders(self._format_urn)
                # An accepts_all_formats codec still only decodes its
                # own stream kind — don't waste a failed open (and a
                # warning) trying the audio codec on a video stream.
                want_type = getattr(self, 'connector_stream_type', None)
                if want_type:
                    codecs = [c for c in codecs
                              if c.stream_type in (None, want_type)]
                if not codecs:
                    self._fail('No codecs found to handle format '
                               '"%s".' % (self._format_urn,))
                    return
                for codec_class in codecs:
                    try:
                        codec = codec_class()
                    except Exception:
                        _log.warning('Error while creating instance of '
                                     'codec {0}', codec_class.__name__,
                                     exc_info=True)
                        continue
                    try:
                        self.decoder = codec.create_decoder(
                            self._pktstream, self._offset, self._length)
                        self.codec = codec
                        break
                    except Exception:
                        _log.warning('Error while trying codec {0}',
                                     codec.urn, exc_info=True)
                if not self.decoder:
                    self._fail('No codecs found to handle format '
                               '"%s". All codecs that were tried failed. '
                               'See log for details.'
                               % (self._format_urn,))
                    return

            self.follow_alerts(self.decoder)
            self.set_format(None)
            self.set_base_filter(self.decoder,
                                 new_range=self.decoder.defined_range)
            self.set_format(self.decoder.format)
        except Exception:
            # %-format, not concatenation: format_urn is legally None
            # when codec_urn was supplied, and a raising error handler
            # would mask the original failure instead of publishing it
            _log.warning('Error while finding codec for format "%s"'
                         % (self._format_urn,), exc_info=True)
            self._fail('Error while finding codec for format "%s"'
                       % (self._format_urn,), exc_info=True)


class VideoDecoderConnector(_DecoderConnector, VideoStream):
    connector_stream_type = 'video'

    def __init__(self, *args, **kw):
        VideoStream.__init__(self)
        _DecoderConnector.__init__(self, *args, **kw)


class AudioDecoderConnector(_DecoderConnector, AudioStream):
    connector_stream_type = 'audio'

    def __init__(self, *args, **kw):
        AudioStream.__init__(self)
        _DecoderConnector.__init__(self, *args, **kw)
