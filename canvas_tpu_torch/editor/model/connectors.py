"""Reference resolvers: AssetStreamRef -> live stream, with alerts.

Behavioral rebuild of the reference's fluggo/editor/model/connectors.py
(:25-238). Both connectors share one resolution algorithm: look up the
asset, bring its source online, fetch the named stream, follow its
alerts; on any failure degrade to an empty stream and publish an alert.
"""

from canvas_tpu_torch import logging as _logging
from canvas_tpu_torch.editor import plugins
from canvas_tpu_torch.editor.model import assets as sources

_log = _logging.getLogger(__name__)

__all__ = ['VideoSourceRefConnector', 'AudioSourceRefConnector']


class _RefConnectorMixin:
    _stream_kind = 'video'

    def _init_connector(self, asset_list, ref, model_obj):
        self.asset_list = asset_list
        self.ref = ref
        self.model_obj = model_obj
        self.asset = None
        self.source = None
        self.stream = None
        self._error = None
        self.connect()

    def set_ref(self, ref):
        self.ref = ref
        self.connect()

    def _clear(self):
        self.set_base_filter(None, new_range=(None, None))
        self.set_format(None)

    def _fail(self, description, exc_info=False):
        self._clear()
        self._error = plugins.Alert(description, model_obj=self.model_obj,
                                    icon=plugins.AlertIcon.Error,
                                    exc_info=exc_info)
        self.show_alert(self._error)

    def connect(self):
        try:
            self.asset = None
            if self.source:
                self.unfollow_alerts(self.source)
                self.source = None
            if self.stream:
                self.unfollow_alerts(self.stream)
                self.stream = None
            if self._error:
                self.hide_alert(self._error)
                self._error = None

            if not self.ref:
                self._clear()
                return
            if not isinstance(self.ref, sources.AssetStreamRef):
                self._clear()
                return

            try:
                self.asset = self.asset_list[self.ref.asset_path]
            except KeyError:
                self._fail('Reference refers to asset "' +
                           self.ref.asset_path + '", which doesn\'t exist.')
                return

            if not self.asset.is_source:
                self._fail('Reference refers to asset "' +
                           self.ref.asset_path + '" which is not a ' +
                           self._stream_kind + ' source.')
                return

            try:
                self.source = self.asset.get_source()
            except Exception:
                self._fail('Error while getting source from asset')
                return

            self.follow_alerts(self.source)

            if self.source.offline:
                try:
                    self.source.bring_online()
                except Exception:
                    self._fail('Error while bringing source online',
                               exc_info=True)
                    return

            if self.source.offline:
                self._clear()
                if not self.source.alerts:
                    self._error = plugins.Alert(
                        'Unable to bring source "' + self.ref.asset_path +
                        '" online.', model_obj=self.model_obj,
                        icon=plugins.AlertIcon.Error)
                    self.show_alert(self._error)
                return

            try:
                self.stream = self.source.get_stream(self.ref.stream)
            except KeyError:
                self._fail('Can\'t find stream "' + str(self.ref.stream) +
                           '" in source "' + self.ref.asset_path + '".')
                return

            self.follow_alerts(self.stream)

            self.set_format(None)
            self.set_base_filter(self.stream,
                                 new_range=self.stream.defined_range)
            self.set_format(self.stream.format)
        except Exception:
            _log.debug('Error while resolving reference', exc_info=True)
            self._fail('Error while resolving reference', exc_info=True)


class VideoSourceRefConnector(_RefConnectorMixin, plugins.VideoStream):
    """Resolves a reference into a video stream (connectors.py:25-146)."""

    _stream_kind = 'video'

    def __init__(self, asset_list, ref, model_obj=None):
        plugins.VideoStream.__init__(self)
        self._init_connector(asset_list, ref, model_obj)


class AudioSourceRefConnector(_RefConnectorMixin, plugins.AudioStream):
    """Resolves a reference into an audio stream (connectors.py:149-238)."""

    _stream_kind = 'audio'

    def __init__(self, asset_list, ref, model_obj=None):
        plugins.AudioStream.__init__(self)
        self._init_connector(asset_list, ref, model_obj)
