"""Headless editor application: project lifecycle + playback wiring.

Equivalent of the reference's qttest.py MainWindow/UIManager glue
(:88, :393-426, :500-903) with the Qt chrome removed: plugin loading,
YAML project open/save, per-space editors with undo stacks, an alert
manager, and clock/playback wiring. A GUI shell (Qt, web, ...) drives
this object; tests and batch tools drive it directly.

The port's app (the counterpart of ``canvas_tpu.editor.ui.app``) keeps a
``device``: every playback engine a space starts renders there (None:
the card, raising without one; ``'cpu'``: the kernels' plain versions).
Projects open and save through ``canvas_tpu_torch.editor.yamlio``'s own
loader and dumper, never PyYAML's global classes, which stay the JAX
editor's; the tags are the same, so either editor opens what the other
saved.
"""

import fractions

from canvas_tpu_torch import backend
from canvas_tpu_torch.clock import SystemPresentationClock
from canvas_tpu_torch.editor import model, plugins, yamlio
from canvas_tpu_torch.editor.model.undo import UndoStack
from canvas_tpu_torch.editor.ui.canvas_models import (AssetDragController,
                                                      CanvasSceneModel,
                                                      DragController,
                                                      HandleDragController)
from canvas_tpu_torch.editor.ui.notification import AlertListModel
from canvas_tpu_torch.signal import Signal

__all__ = ['EditorApp', 'SpaceEditor']


class SpaceEditor:
    """One open composition: scene model + undo stack + graph managers
    (qttest.py SpaceEditor, :462-498)."""

    def __init__(self, app, space_asset):
        self.app = app
        self.space_asset = space_asset
        self.space = space_asset.space
        self.undo_stack = UndoStack()
        self.scene = CanvasSceneModel(self.space)
        self.drag = DragController(self.scene, self.undo_stack)
        self.handles = HandleDragController(self.scene, self.undo_stack)
        self.asset_drag = AssetDragController(self.scene, self.undo_stack,
                                              app.asset_list)
        self._source = space_asset.get_source()
        self._source.bring_online()

    @property
    def video_stream(self):
        streams = self._source.get_streams()
        return next(s for s in streams if s.stream_type == 'video')

    @property
    def audio_stream(self):
        streams = self._source.get_streams()
        return next(s for s in streams if s.stream_type == 'audio')

    def start_playback(self, present, window, batch=4):
        """Attach a playback engine to the app clock, rendering on the
        app's device."""
        from canvas_tpu_torch.playback import VideoPlaybackEngine
        rate = self.space.video_format.frame_rate
        return VideoPlaybackEngine(self.video_stream, self.app.clock,
                                   rate, window, present, batch=batch,
                                   device=self.app.device)

    def stream_for_item(self, item):
        """Resolve a clip's AssetStreamRef to a live stream (the ref
        connectors' happy path); None when unresolvable (offline
        assets degrade to alert-covered blanks, not errors)."""
        ref = getattr(item, 'source', None)
        if ref is None or not hasattr(ref, 'asset_path'):
            return None
        try:
            asset = self.app.asset_list[ref.asset_path]
            source = asset.get_source()
            if source.offline:
                source.bring_online()
            return source.get_stream(ref.stream)
        except Exception:
            return None

    def paint_timeline(self, width_px, height_px, transform=None,
                       thumbnails=None):
        """Rasterize this space's timeline view into a (H, W, 4) u8
        BGRA buffer (software paint layer; any widget can blit it).
        The playhead follows the app clock."""
        import fractions as _fractions

        from canvas_tpu_torch import process, timecode
        from canvas_tpu_torch.editor.ui.canvas_models import ViewTransformModel
        from canvas_tpu_torch.editor.ui.paint import CanvasPainter
        from canvas_tpu_torch.editor.ui.ruler import TimeRulerModel

        rate = self.space.video_format.frame_rate
        if transform is None:
            transform = ViewTransformModel()
        ruler = TimeRulerModel(
            timecode.Frames(),
            scale=_fractions.Fraction(transform.pixels_per_second) /
            _fractions.Fraction(rate),
            frame_rate=rate)
        # fractional: ticks must align with content drawn at the
        # un-quantized scroll offset (one frame-width of drift per
        # fractional scroll otherwise, amplified by zoom)
        ruler.set_left_frame(float(transform.scroll_x * rate))
        painter = CanvasPainter(self.scene, transform, ruler=ruler)
        playhead = process.get_time_frame(
            rate, self.app.clock.get_presentation_time())
        return painter.paint(width_px, height_px,
                             playhead_frame=playhead, playhead_rate=rate,
                             thumbnails=thumbnails)


class EditorApp:
    def __init__(self, load_plugins=True, audio_master=False,
                 audio_rate=48000, audio_channels=2, audio_sink=None,
                 device=None):
        """audio_master=True makes the audio output thread THE
        presentation clock (the reference wires AlsaPlayer as the
        UIManager clock, qttest.py:393-426): video follows what the
        audio sink actually consumed. The current space's audio stream
        feeds the player automatically on open. *device* is where the
        spaces' playback renders (None: the card)."""
        self.device = backend.resolve_device(device)
        if load_plugins:
            plugins.PluginManager.load_all()
        self.asset_list = model.AssetList()
        self.alert_model = AlertListModel(
            plugins.PluginManager.alert_manager)
        self.editors = []
        self.current_editor = None
        if audio_master:
            from canvas_tpu_torch.audioout import AudioPlayer
            self.clock = AudioPlayer(audio_rate, audio_channels,
                                     sink=audio_sink)
        else:
            self.clock = SystemPresentationClock()
        self.editor_added = Signal()

    def close(self):
        """Shut down the clock's audio thread (if audio-master)."""
        close = getattr(self.clock, 'close', None)
        if close is not None:
            close()

    # -- project lifecycle (qttest.py:795-827) ----------------------------

    def open_file(self, path):
        with open(path) as stream:
            project = yamlio.load(stream)
        project.fixup()
        self.set_asset_list(project.assets)
        return project

    def save_file(self, path, project=None):
        if project is None:
            project = model.Project(assets=self.asset_list)
        with open(path, 'w') as stream:
            yamlio.dump(project, stream)

    def set_asset_list(self, asset_list):
        self.asset_list = asset_list
        # Audio-master clock: the old project's audio graph must not
        # keep playing through the sink after the project is replaced.
        if hasattr(self.clock, 'set_audio_source'):
            self.clock.set_audio_source(None)
        self.editors = []
        self.current_editor = None

    # -- editors ----------------------------------------------------------

    def open_space(self, asset_name):
        asset = self.asset_list[asset_name]
        editor = SpaceEditor(self, asset)
        self.editors.append(editor)
        self.current_editor = editor
        # Audio-master clock: feed it the space's audio graph
        # (qttest.py handle_editor_changed -> set_audio_source)
        if hasattr(self.clock, 'set_audio_source'):
            try:
                self.clock.set_audio_source(editor.audio_stream)
            except StopIteration:
                pass              # space exposes no audio stream
        self.editor_added(editor)
        return editor

    def new_space(self, name, video_format=None, audio_format=None):
        video_format = video_format or plugins.VideoFormat(
            frame_rate=fractions.Fraction(30000, 1001))
        audio_format = audio_format or plugins.AudioFormat(sample_rate=48000)
        space = model.Space(name, video_format, audio_format)
        asset = model.SpaceAsset(space, name=name)
        self.asset_list[name] = asset
        return self.open_space(name)

    # -- assets -----------------------------------------------------------

    def import_file(self, name, path):
        """Probe a media file through the source plugins and add it as an
        asset (the reference's source list drop handler)."""
        for plugin in plugins.PluginManager.find_plugins(
                plugins.SourcePlugin):
            source = plugin.create_source_from_file(name, path)
            if source is not None:
                asset = model.PluginSourceAsset(
                    name, plugin.plugin_urn, source.get_definition())
                self.asset_list[name] = asset
                return asset
        raise IOError('No plugin could read ' + path)

    def add_asset_to_space(self, editor, asset_name, x=0, y=0.0,
                           length=None):
        """Drop an asset into a space: one clip per default stream (the
        source-list drag handler's job in the reference UI). Returns the
        created items."""
        asset = self.asset_list[asset_name]
        source = asset.get_source()
        if source.offline:
            source.bring_online()
        streams = source.get_default_streams()

        items = []
        for lane, stream in enumerate(streams):
            rng = stream.defined_range
            if length is not None:
                item_length = length
            elif rng and rng[1] is not None:
                item_length = rng[1] - (rng[0] or 0) + 1
            else:
                item_length = 100
            clip = model.Clip(
                type=stream.stream_type, x=int(x), y=float(y) + lane,
                length=int(item_length), height=1.0,
                source=model.AssetStreamRef(asset_name, stream.name),
                offset=0)
            items.append(clip)

        editor.undo_stack.push(model.CompoundCommand(
            'Add asset to space',
            [model.InsertItemCommand(editor.space, clip, len(editor.space))
             for clip in items]))
        return items

    # -- transport --------------------------------------------------------

    def play(self, rate=1):
        self.clock.play(rate)

    def stop(self):
        self.clock.stop()

    def seek(self, time_ns):
        self.clock.seek(time_ns)
