"""Editor plugin framework (reference fluggo.editor.plugins)."""

from canvas_tpu_torch.editor.plugins._base import (  # noqa: F401
    Alert, AlertIcon, AlertPublisher, Plugin, PluginManager, PluginModule)
from canvas_tpu_torch.editor.plugins._source import (  # noqa: F401
    SourceOfflineError, KnownIlluminants, SourcePlugin, Source, VideoFormat,
    AudioFormat, VideoStream, AudioStream, PULLDOWN_NONE, PULLDOWN_23,
    PULLDOWN_2332)
from canvas_tpu_torch.editor.plugins._codec import (  # noqa: F401
    CodecPlugin, Codec, NotConnectedError, VideoDecoderConnector,
    AudioDecoderConnector)
