"""Editor main window (the reference's qttest.py MainWindow, :500-903).

Builds the full editing surface over EditorApp: document tabs holding
timeline views (software paint layer + mouse editing through
DragController), a video-preview dock, asset/alert/undo docks, File and
Edit menus, and a transport toolbar driven by the app clock.

Parameterized over the Qt binding the same way editor/ui/qt.py is, so
the whole window runs against PyQt5/PyQt6/PySide6 when installed and
against a fake binding in tests.

The port's window (the counterpart of ``canvas_tpu.editor.ui.mainwindow``)
renders on its app's device: the timelines' thumbnail pull queues, the
preview widget and ``render_space`` all use ``app.device`` (None: the
card).
"""

import fractions

from canvas_tpu_torch import backend
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.editor.ui import qt as qt_shim

__all__ = ['MainWindow', 'create_main_window']


def create_main_window(app=None, binding=None, device=None):
    """Build the main window class against the active Qt binding and
    return an instance. *app* is an EditorApp (created on *device* when
    None; a given app keeps its own device, and a *device* that differs
    from it raises)."""
    qt = binding or qt_shim._load_qt()
    if not qt:
        raise RuntimeError('No Qt binding (PyQt5/PyQt6/PySide6) available')
    QtWidgets, QtGui, QtCore = qt

    from canvas_tpu_torch.editor.ui import EditorApp
    from canvas_tpu_torch.editor.ui.canvas_models import ViewTransformModel

    if app is None:
        app = EditorApp(device=device)
    elif device is not None and \
            backend.resolve_device(device) != app.device:
        raise ValueError('device %r differs from the app\'s %r'
                         % (device, app.device))

    class TimelineWidget(QtWidgets.QWidget):
        """One open space: blits SpaceEditor.paint_timeline and routes
        mouse input into the scene model + DragController."""

        # Thumbnails land on the VideoPullQueue worker thread; this
        # signal hops the repaint onto the GUI thread (the same
        # pattern as qt.py's _frame_ready).
        _thumbs_changed = QtCore.pyqtSignal() \
            if hasattr(QtCore, 'pyqtSignal') else QtCore.Signal()

        def __init__(self, editor, parent=None):
            super().__init__(parent)
            self.editor = editor
            self.transform = ViewTransformModel()
            # snap-to-edges: drags through this widget show snap bars
            # and quantize to neighbor edges (DragController._snap)
            editor.drag.transform = self.transform
            editor.handles.transform = self.transform
            self._image = None
            self._drag_active = False
            self._handle_active = False
            accept_drops = getattr(self, 'setAcceptDrops', None)
            if callable(accept_drops):
                accept_drops(True)
            self._thumb_painters = {}     # item -> ThumbnailPainter
            self._thumbs_changed.connect(self.refresh)

        def enable_thumbnails(self, size=(48, 32), window=None):
            """Async thumbnail strips inside video clips
            (ui/canvas/thumbnails.py role): one painter per resolvable
            clip; refresh as each thumbnail lands. The pull window
            comes from the stream format's full_frame unless given."""
            from canvas_tpu_torch.editor.ui import ThumbnailPainter
            # ONE shared pull queue for every clip's painter, on the
            # app's device: a private queue per clip costs 3 threads +
            # its own planner cache each (50 clips -> ~150 threads)
            queue = getattr(self, '_thumb_queue', None)
            if queue is None:
                from canvas_tpu_torch.pullqueue import VideoPullQueue
                queue = self._thumb_queue = VideoPullQueue(
                    device=self.editor.app.device)
            for item in self.editor.space:
                if item in self._thumb_painters or \
                        item.type() != 'video':
                    continue
                stream = self.editor.stream_for_item(item)
                if stream is None:
                    continue
                win = window
                if win is None:
                    fmt = getattr(stream, 'format', None)
                    win = getattr(fmt, 'full_frame', None)
                painter = ThumbnailPainter(stream=stream, size=size,
                                           count=1, window=win,
                                           queue=queue)
                painter.set_range(item.offset, max(1, item.length))
                painter.thumbnail_ready.connect(
                    lambda *_a: self._thumbs_changed.emit())
                painter.request_all()
                self._thumb_painters[item] = painter

        def _thumbnail_map(self):
            out = {}
            for item, painter in self._thumb_painters.items():
                thumb = painter.thumbnail(0)
                if thumb is not None:
                    out[item] = thumb
            return out

        # -- painting ------------------------------------------------

        def _view_size(self):
            r = self.rect()
            w = r.width() if callable(getattr(r, 'width', None)) else 640
            h = r.height() if callable(getattr(r, 'height', None)) else 240
            return max(64, w), max(64, h)

        def refresh(self):
            w, h = self._view_size()
            buf = self.editor.paint_timeline(
                w, h, transform=self.transform,
                thumbnails=self._thumbnail_map())
            # QImage does NOT copy the buffer — keep the bytes alive.
            self._image_data = buf.tobytes()
            self._image = QtGui.QImage(self._image_data, w, h, w * 4,
                                       QtGui.QImage.Format.Format_ARGB32)
            self.update()

        def paintEvent(self, event):
            painter = QtGui.QPainter(self)
            if self._image is not None:
                painter.drawImage(self.rect(), self._image)
            else:
                painter.fillRect(self.rect(), QtCore.Qt.GlobalColor.black)
            painter.end()

        # -- mouse editing (scene.py/manip.py routing) ------------------

        def _scene_pos(self, px, py):
            x, y = self.transform.view_to_scene(px, py - self.RULER_HEIGHT)
            return x, y

        RULER_HEIGHT = 18

        def _preview_engine_for_scrub(self):
            getter = getattr(self, 'preview_engine', None)
            if getter is None:
                return None
            try:
                return getter()
            except Exception:
                return None

        def _scrub_to(self, px):
            seconds, _lane = self.transform.view_to_scene(px, 0)
            self.editor.app.seek(int(max(0.0, seconds) * 1_000_000_000))

        def mouse_press(self, px, py):
            if py < self.RULER_HEIGHT:
                # Time-ruler scrub (the qttest.py playhead drag):
                # degrade preview quality while dragging
                # (hints.rst intent), restore on release.
                self._scrub_active = True
                engine = self._preview_engine_for_scrub()
                if engine is not None:
                    engine.set_quality(4)
                self._scrub_to(px)
                self.refresh()
                return
            x, y = self._scene_pos(px, py)
            scene = self.editor.scene
            # Edge-handle zones win over body drags (the reference's
            # Handle items sit on top of the clip body, clip.py:29-62)
            hit = self.editor.handles.hit_test(x, y)
            if hit is not None:
                self.editor.handles.start(hit[0], hit[1], x, y)
                self._handle_active = True
                self.refresh()
                return
            item = scene.item_at(x, y)
            scene.select([item] if item is not None else [])
            if item is not None:
                self.editor.drag.start(item, x, y)
                self._drag_active = True
            self.refresh()

        def mouse_move(self, px, py):
            if getattr(self, '_scrub_active', False):
                self._scrub_to(px)
                self.refresh()
                return
            if self._handle_active:
                self.editor.handles.move(*self._scene_pos(px, py))
                self.refresh()
                return
            if self._drag_active:
                x, y = self._scene_pos(px, py)
                # Hovering over a Sequence item routes the drag into the
                # sequence (the reference's sequence-insertion drag,
                # manip.py set_sequence_item); otherwise move in space.
                from canvas_tpu_torch.editor import model as _model
                dragged = set(self.editor.scene.selected_items)
                target = self.editor.scene.item_at(x, y, exclude=dragged)
                if isinstance(target, _model.Sequence):
                    try:
                        self.editor.drag.move_to_sequence(target, x, y)
                        self.refresh()
                        return
                    except (NotImplementedError, ValueError):
                        pass
                self.editor.drag.move_to_space(x, y)
                self.refresh()

        def mouse_release(self, px, py):
            if getattr(self, '_scrub_active', False):
                self._scrub_active = False
                self._scrub_to(px)
                engine = self._preview_engine_for_scrub()
                if engine is not None:
                    engine.set_quality(10)
                self.refresh()
                return
            if self._handle_active:
                self._handle_active = False
                self.editor.handles.drop()
                self.refresh()
                return
            if self._drag_active:
                try:
                    self.editor.drag.drop()
                finally:
                    # a failed finish() rolls the gesture back inside
                    # drop(); the widget must still leave drag mode
                    self._drag_active = False
                    self.refresh()

        # -- asset drag-drop (scene.py:219-353 role) --------------------

        def asset_drag_enter(self, asset_path):
            """A drag from the asset dock entered the timeline."""
            return self.editor.asset_drag.enter(asset_path)

        def asset_drag_move(self, px, py):
            x, y = self._scene_pos(px, py)
            ctrl = self.editor.asset_drag
            from canvas_tpu_torch.editor import model as _model
            dragged = set(ctrl.items or ())
            target = self.editor.scene.item_at(x, y, exclude=dragged)
            if isinstance(target, _model.Sequence):
                try:
                    ctrl.move(x, y, sequence=target)
                    self.refresh()
                    return
                except (NotImplementedError, ValueError):
                    pass
            ctrl.move(x, y)
            self.refresh()

        def asset_drag_leave(self):
            self.editor.asset_drag.leave()
            self.refresh()

        def asset_drop(self, px, py):
            ctrl = self.editor.asset_drag
            if ctrl.error or ctrl.offline:
                # surface the reference's QMessageBox as an app alert
                from canvas_tpu_torch.editor import plugins as _plugins
                self.editor.app.alert_model.show_alert(_plugins.Alert(
                    'Could not bring the asset online',
                    icon=_plugins.AlertIcon.Error, source='asset drag'))
                ctrl.leave()
                self.refresh()
                return None
            self.asset_drag_move(px, py)
            command = ctrl.drop()
            self.refresh()
            return command

        @staticmethod
        def _drag_asset_name(event):
            """Asset path from a Qt drag event: text mime, else the
            dragged row of a source list widget."""
            md = event.mimeData() if callable(
                getattr(event, 'mimeData', None)) else None
            text = md.text() if md is not None and callable(
                getattr(md, 'text', None)) else ''
            if text:
                return text
            src = event.source() if callable(
                getattr(event, 'source', None)) else None
            cur = getattr(src, 'currentItem', None)
            if callable(cur):
                item = cur()
                if item is not None:
                    return item.text()
            return None

        def dragEnterEvent(self, event):
            name = self._drag_asset_name(event)
            if name is not None and self.asset_drag_enter(name):
                event.acceptProposedAction()

        def dragMoveEvent(self, event):
            if self.editor.asset_drag.items is not None:
                self.asset_drag_move(*self._event_xy(event))
                event.acceptProposedAction()

        def dragLeaveEvent(self, event):
            self.asset_drag_leave()

        def dropEvent(self, event):
            if self.asset_drop(*self._event_xy(event)) is not None:
                event.acceptProposedAction()

        def wheel(self, px, steps):
            """Zoom the timeline about the cursor (view.py:172-187
            role; ViewTransformModel keeps the anchor stationary)."""
            self.transform.zoom(steps, anchor_px=px)
            self.refresh()

        def wheelEvent(self, event):
            delta = 0
            angle = getattr(event, 'angleDelta', None)
            if angle is not None:
                delta = angle().y()
            if delta:
                px = self._event_xy(event)[0]
                self.wheel(px, 1 if delta > 0 else -1)

        # Qt event names route to the toolkit-independent handlers.
        # position() is Qt6; Qt5 uses localPos()/pos().
        @staticmethod
        def _event_xy(event):
            for name in ('position', 'localPos', 'pos'):
                getter = getattr(event, name, None)
                if getter is not None:
                    p = getter()
                    return p.x(), p.y()
            raise AttributeError('mouse event has no position accessor')

        def mousePressEvent(self, event):
            self.mouse_press(*self._event_xy(event))

        def mouseMoveEvent(self, event):
            self.mouse_move(*self._event_xy(event))

        def mouseReleaseEvent(self, event):
            self.mouse_release(*self._event_xy(event))

    class MainWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.app = app
            self.editors = {}          # asset name -> (editor, widget)
            self.video_widget = None
            self._playback_window = box2i(0, 0, 639, 479)

            # Document tabs (qttest.py:546-560)
            self.document_tabs = QtWidgets.QTabWidget()
            self.setCentralWidget(self.document_tabs)

            # Docks (qttest.py:527-544). The asset dock is a SEARCH
            # dock: a filter box above the list, matching the
            # reference's AssetSearchModel substring search
            # (qttest.py:120-128).
            self.asset_dock = QtWidgets.QDockWidget('Assets')
            asset_panel = QtWidgets.QWidget()
            asset_layout = QtWidgets.QVBoxLayout(asset_panel)
            self.asset_search = QtWidgets.QLineEdit()
            set_placeholder = getattr(self.asset_search,
                                      'setPlaceholderText', None)
            if callable(set_placeholder):
                set_placeholder('Search assets')
            self.asset_list_widget = QtWidgets.QListWidget()
            # assets drag onto the timeline (scene.py drag-drop role);
            # TimelineWidget._drag_asset_name reads the dragged row
            drag_enable = getattr(self.asset_list_widget,
                                  'setDragEnabled', None)
            if callable(drag_enable):
                drag_enable(True)
            asset_layout.addWidget(self.asset_search)
            asset_layout.addWidget(self.asset_list_widget)
            self.asset_dock.setWidget(asset_panel)
            self.asset_search.textChanged.connect(self._on_assets_changed)
            self.addDockWidget(QtCore.Qt.DockWidgetArea.BottomDockWidgetArea,
                               self.asset_dock)

            self.alerts = getattr(app, 'alert_model', None)
            self.alert_dock = QtWidgets.QDockWidget('Notifications')
            self.alert_list_widget = QtWidgets.QListWidget()
            self.alert_dock.setWidget(self.alert_list_widget)
            self.addDockWidget(QtCore.Qt.DockWidgetArea.BottomDockWidgetArea,
                               self.alert_dock)
            if self.alerts is not None:
                self.alerts.rows_changed.connect(self._refresh_alerts)
                self._refresh_alerts()

            # Undo history dock (qttest.py UndoDockWidget, :292)
            self.undo_dock = QtWidgets.QDockWidget('Undo')
            self.undo_list_widget = QtWidgets.QListWidget()
            self.undo_dock.setWidget(self.undo_list_widget)
            self.addDockWidget(QtCore.Qt.DockWidgetArea.BottomDockWidgetArea,
                               self.undo_dock)

            self.video_dock = QtWidgets.QDockWidget('Video Preview')
            self.addDockWidget(QtCore.Qt.DockWidgetArea.BottomDockWidgetArea,
                               self.video_dock)

            # Asset list follows the model's signals (the reference's
            # asset search dock stays live, qttest.py:157-289)
            self._wire_asset_signals()

            # Menus (qttest.py:629-646)
            bar = self.menuBar()
            self.file_menu = bar.addMenu('&File')
            self.act_open = self.file_menu.addAction('&Open project...')
            self.act_save = self.file_menu.addAction('&Save project...')
            self.act_render = self.file_menu.addAction('&Render...')
            self.act_quit = self.file_menu.addAction('&Quit')
            self.edit_menu = bar.addMenu('&Edit')
            self.act_undo = self.edit_menu.addAction('&Undo')
            self.act_redo = self.edit_menu.addAction('&Redo')
            self.act_bring_forward = self.edit_menu.addAction(
                'Bring &forward')
            self.act_send_back = self.edit_menu.addAction('Send &back')
            self.tools_menu = bar.addMenu('&Tools')
            self.act_edit_plugins = self.tools_menu.addAction(
                'Edit &plugins...')
            self.act_edit_decoders = self.tools_menu.addAction(
                'Edit &decoders...')

            # Transport toolbar (qttest.py:553-558)
            self.transport = QtWidgets.QToolBar()
            self.act_play = self.transport.addAction('Play')
            self.act_stop = self.transport.addAction('Stop')
            self.act_rewind = self.transport.addAction('Rewind')
            self.addToolBar(self.transport)

            for action, slot in ((self.act_undo, self.undo),
                                 (self.act_redo, self.redo),
                                 (self.act_bring_forward,
                                  self.bring_forward),
                                 (self.act_send_back, self.send_back),
                                 (self.act_play, self.play),
                                 (self.act_stop, self.stop),
                                 (self.act_rewind, self.rewind),
                                 (self.act_edit_plugins, self.edit_plugins),
                                 (self.act_edit_decoders,
                                  self.edit_decoders),
                                 (self.act_render, self._render_requested),
                                 (self.act_quit, self.close)):
                action.triggered.connect(slot)

            # Async exports (File > Render): progress/finished fan out
            # to whatever transport/status UI the embedding wires up;
            # render_requested lets it supply the save path (the
            # reference prompts with QFileDialog, qttest.py:834).
            from canvas_tpu_torch.signal import Signal as _Signal
            self._render_jobs = []
            self._pending_render_alerts = []
            self.render_requested = _Signal()
            self.render_progress = _Signal()
            self.render_finished = _Signal()

        # -- project I/O (qttest.py:795-827) --------------------------

        def _wire_asset_signals(self):
            for signal_name in ('added', 'renamed'):
                signal = getattr(self.app.asset_list, signal_name, None)
                if signal is not None:
                    signal.connect(self._on_assets_changed)
            # removed() fires while the asset is still listed (the
            # handlers are "the last to see it", assets.AssetList._orphan)
            # — refreshing verbatim would re-list the dying asset, so
            # exclude it by name
            removed = getattr(self.app.asset_list, 'removed', None)
            if removed is not None:
                removed.connect(self._on_asset_removed)

        def open_project(self, path):
            self.app.open_file(path)
            # open_file swaps in a NEW AssetList: follow the new one
            self._wire_asset_signals()
            self._refresh_assets()
            for name, asset in self.app.asset_list.items():
                if getattr(asset, 'space', None) is not None:
                    self.open_space(name)

        def save_project(self, path):
            self.app.save_file(path)

        def _refresh_assets(self, exclude=None):
            # case-insensitive substring filter, the reference's
            # AssetSearchModel._match (qttest.py:120-121)
            needle = (self.asset_search.text() or '').lower()
            self.asset_list_widget.clear()
            for name in self.app.asset_list:
                if name != exclude and needle in name.lower():
                    self.asset_list_widget.addItem(name)

        def _on_assets_changed(self, *args):
            self._refresh_assets()

        def _on_asset_removed(self, name):
            self._refresh_assets(exclude=name)

        def _refresh_alerts(self, *args):
            self.alert_list_widget.clear()
            for i in range(len(self.alerts)):
                self.alert_list_widget.addItem(self.alerts.row_text(i))

        def _refresh_undo(self):
            self.undo_list_widget.clear()
            editor = self.current_editor
            if editor is None:
                return
            stack = editor.undo_stack
            for i, command in enumerate(stack._commands):
                marker = '* ' if i < stack.index else '  '
                self.undo_list_widget.addItem(marker + (command.text() or
                                                        '<command>'))

        # -- spaces ----------------------------------------------------

        def _register_editor(self, name, editor):
            widget = TimelineWidget(editor)
            self._timeline_widgets = getattr(self, '_timeline_widgets', [])
            self._timeline_widgets.append(widget)
            # ruler scrubbing degrades the ACTIVE preview engine while
            # dragging (quality hint); resolved lazily since the
            # preview widget swaps with the active tab
            widget.preview_engine = (
                lambda: self.video_widget.engine
                if self.video_widget is not None else None)
            self.document_tabs.addTab(widget, name)
            self.editors[name] = (editor, widget)
            widget.refresh()
            # undo history dock follows every push/undo/redo
            editor.undo_stack.index_changed.connect(
                self._on_undo_index_changed)
            self._attach_preview(editor)
            self._refresh_assets()
            self._refresh_undo()
            return editor

        def _on_undo_index_changed(self, *args):
            self._refresh_undo()

        def open_space(self, name):
            if name in self.editors:
                return self.editors[name][0]
            return self._register_editor(name, self.app.open_space(name))

        def new_space(self, name, video_format=None, audio_format=None):
            return self._register_editor(
                name, self.app.new_space(name, video_format, audio_format))

        def _attach_preview(self, editor):
            if self.video_widget is not None:
                self.video_widget.close()
            rate = editor.space.video_format.frame_rate or \
                fractions.Fraction(30000, 1001)
            self.video_widget = qt_shim.VideoWidget(
                editor.video_stream, self.app.clock, rate,
                self._playback_window, on_stall=self._playback_stall,
                device=self.app.device)
            self.video_dock.setWidget(self.video_widget)

        def _playback_stall(self, stalled):
            """Surface render-stall state in the alert dock (the
            device-transport analog of an offline source: alert, don't
            freeze silently)."""
            from canvas_tpu_torch.editor import plugins as plugins_mod
            manager = plugins_mod.PluginManager.alert_manager
            alert = getattr(self, '_stall_alert', None)
            if stalled:
                if alert is None:
                    alert = plugins_mod.Alert(
                        'Playback stalled: the render device stopped '
                        'responding (transport down or degraded). '
                        'Playback resumes automatically if it recovers.',
                        icon=plugins_mod.AlertIcon.Error,
                        source='playback', key='playback-stall')
                    self._stall_alert = alert
                manager.show_alert(alert)
            elif alert is not None:
                manager.hide_alert(alert)

        @property
        def current_editor(self):
            # The editor behind the ACTIVE document tab: Undo/Redo, the
            # undo dock, and transport must act on the space the user is
            # looking at, not the first one opened.
            current = self.document_tabs.currentWidget()
            if current is not None:
                for editor, widget in self.editors.values():
                    if widget is current:
                        return editor
            for editor, widget in self.editors.values():
                return editor
            return None

        # -- actions ---------------------------------------------------

        def undo(self, *a):
            editor = self.current_editor
            if editor is not None:
                editor.undo_stack.undo()
                self.editors_refresh()

        def _restack_selection(self, direction):
            # the reference view's canvas_bring_forward/send_backward
            # (view.py:279-317): one undo entry per selection restack
            from canvas_tpu_torch.editor.ui.canvas_models import \
                z_order_commands
            editor = self.current_editor
            if editor is None:
                return
            items = editor.scene.selected_items
            if not items:
                return
            command = z_order_commands(items, direction)
            if command is not None:
                editor.undo_stack.push(command)
                self.editors_refresh()

        def bring_forward(self, *a):
            self._restack_selection('forward')

        def send_back(self, *a):
            self._restack_selection('back')

        def redo(self, *a):
            editor = self.current_editor
            if editor is not None:
                editor.undo_stack.redo()
                self.editors_refresh()

        def editors_refresh(self):
            for _editor, widget in self.editors.values():
                widget.refresh()
            self._refresh_undo()

        def play(self, *a):
            self.app.play(1)

        def stop(self, *a):
            self.app.stop()

        def rewind(self, *a):
            self.app.seek(0)

        def edit_plugins(self, *a):
            """Plugin settings dock (the reference's plugin editor
            dialog, qttest.py:645): one row per plugin with its enabled
            state; toggled via the model (persists to settings)."""
            from canvas_tpu_torch.editor.ui.settings_models import \
                PluginEditorModel
            self.plugin_editor = PluginEditorModel()
            if not hasattr(self, 'plugin_dock'):
                self.plugin_dock = QtWidgets.QDockWidget('Plugins')
                self.plugin_list_widget = QtWidgets.QListWidget()
                self.plugin_dock.setWidget(self.plugin_list_widget)
                self.addDockWidget(
                    QtCore.Qt.DockWidgetArea.BottomDockWidgetArea,
                    self.plugin_dock)
            widget = self.plugin_list_widget
            widget.clear()
            for (_plugin, name, _desc, enabled) in \
                    self.plugin_editor.rows():
                widget.addItem('%s [%s]' % (name,
                                            'on' if enabled else 'off'))
            return self.plugin_editor

        def edit_decoders(self, *a):
            """Decoder priority editor (qttest.py:646 role)."""
            from canvas_tpu_torch.editor.ui.settings_models import \
                DecoderEditorModel
            self.decoder_editor = DecoderEditorModel()
            if not hasattr(self, 'decoder_dock'):
                self.decoder_dock = QtWidgets.QDockWidget('Decoders')
                self.decoder_list_widget = QtWidgets.QListWidget()
                self.decoder_dock.setWidget(self.decoder_list_widget)
                self.addDockWidget(
                    QtCore.Qt.DockWidgetArea.BottomDockWidgetArea,
                    self.decoder_dock)
            widget = self.decoder_list_widget
            widget.clear()
            for (_dec, name, _urns, enabled, priority) in \
                    self.decoder_editor.rows():
                widget.addItem('%s [prio %d%s]' % (
                    name, priority, '' if enabled else ', off'))
            return self.decoder_editor

        def flush_render_alerts(self):
            """Drain worker-thread render failures into the alert dock.
            Call from the GUI thread (the render-progress timer does)."""
            from canvas_tpu_torch.editor import plugins as plugins_mod
            while self._pending_render_alerts:
                path, error = self._pending_render_alerts.pop(0)
                plugins_mod.PluginManager.alert_manager.show_alert(
                    plugins_mod.Alert(
                        'Render to %s failed: %s' % (path, error),
                        icon=plugins_mod.AlertIcon.Error,
                        source='render', exc_info=False))

        def _render_requested(self):
            """File > Render: the embedding supplies the save path (a
            real app connects a file dialog here — qttest.py:834 — and
            calls render_space(path, block=False))."""
            self.render_requested()

        def render_space(self, path, block=True, **kw):
            """Export the current space with write_video (the render
            dialog's job, qttest.py:829).

            block=False runs the export on a RenderJob worker thread
            (the RenderProgressDialog role, qttest.py:862-865) and
            returns the started job: progress fans out to
            self.render_progress(done, total), completion to
            self.render_finished(error), and a failure lands in the
            alert dock. block=True (scripts, tests) runs inline and
            returns None."""
            editor = self.current_editor
            rate = editor.space.video_format.frame_rate or \
                fractions.Fraction(30000, 1001)
            length = max((item.x + item.length for item in editor.space),
                         default=0)
            kw.setdefault('frame_rate', rate)
            if block:
                from canvas_tpu_torch import libav
                libav.write_video(path, editor.video_stream, None, 0,
                                  length, device=self.app.device, **kw)
                return None

            from canvas_tpu_torch.editor.ui.renderprogress import RenderJob
            job = RenderJob(path, editor.video_stream, None, 0, length,
                            device=self.app.device, **kw)

            def on_finished(error):
                # Fires on the RenderJob worker thread: alerts refresh
                # Qt widgets (_refresh_alerts), which must only happen
                # on the GUI thread — stash the failure and let the
                # GUI-side poller (the editor entry point's timer, or
                # a test) drain it via flush_render_alerts().
                if error is not None:
                    self._pending_render_alerts.append((path, error))
                if job in self._render_jobs:
                    self._render_jobs.remove(job)
                self.render_finished(error)

            job.progress.connect(self.render_progress)
            job.finished.connect(on_finished)
            self._render_jobs.append(job)
            return job.start()

        def closeEvent(self, event):
            for job in list(getattr(self, '_render_jobs', [])):
                job.cancel()
                job.join(timeout=10)
            if self.video_widget is not None:
                self.video_widget.close()
            # tear down each timeline's shared thumbnail pull queue
            for widget in getattr(self, '_timeline_widgets', []):
                queue = getattr(widget, '_thumb_queue', None)
                if queue is not None:
                    queue.close()
                    widget._thumb_queue = None
            # event is None when teardown is driven programmatically
            # (the editor entry point's finally, tests): a real Qt
            # super().closeEvent would dereference the null QCloseEvent
            if event is not None:
                super().closeEvent(event)

    return MainWindow()


def MainWindow(app=None, device=None):
    """qttest.py-style entry: build against the installed binding."""
    return create_main_window(app, device=device)
