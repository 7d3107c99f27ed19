"""Canvas scene model: the geometry/selection/drag logic of the timeline
view (model of fluggo/editor/ui/canvas/).

The reference implements this as QGraphicsScene/QGraphicsItem subclasses
(scene.py, clipitem.py, scrollview.py); here the same responsibilities —
mapping Space items to view rectangles, selection, hit-testing, snapping,
and driving ItemManipulator during drags — live in plain objects a paint
layer can render.
"""


from canvas_tpu_torch.signal import Signal
from canvas_tpu_torch.editor.model.manip import ItemManipulator
from canvas_tpu_torch.editor.model.undo import UndoCommand

__all__ = ['AssetDragController', 'CanvasItemView', 'CanvasSceneModel',
           'DragController', 'HandleDragController', 'ViewTransformModel',
           'SnapMarker', 'z_order_commands']


class CanvasItemView:
    """View state for one Space item: rectangle in scene units
    (x in seconds, y in lane units) + selection flag."""

    def __init__(self, scene, item):
        self.scene = scene
        self.item = item
        self.selected = False
        item.updated.connect(self._handle_updated)
        # Sequences redraw when their inner chain changes (the
        # reference's VideoSequence listens to the same three signals,
        # canvas/sequence.py:215-217)
        for name in ('item_added', 'items_removed', 'item_updated'):
            sig = getattr(item, name, None)
            if sig is not None:
                sig.connect(self._handle_sequence_changed)

    def _handle_updated(self, **kw):
        self.scene.item_changed(self)

    def _handle_sequence_changed(self, *args, **kw):
        self.scene.item_changed(self)

    @property
    def rate(self):
        return self.scene.space.rate(self.item.type())

    @property
    def rect(self):
        """(x_seconds, y, width_seconds, height)."""
        rate = float(self.rate)
        return (self.item.x / rate, self.item.y,
                self.item.length / rate, self.item.height)

    def sub_rects(self):
        """A/B-roll layout for an EXPANDED sequence: list of
        (sequence_item, (x_seconds, y, w_seconds, h)) in scene units,
        or None when the item isn't an expanded sequence.

        Geometry matches the reference's expanded VideoSequence
        (canvas/sequence.py:166,234-238): sub-items sit at
        sequence.x + item.x; even chain indices ride the TOP lane,
        odd the BOTTOM, each 3/7 of the sequence height — transitions
        show as the horizontal A/B overlap."""
        item = self.item
        if not getattr(item, 'expanded', False) or not hasattr(
                item, '__len__'):
            return None
        rate = float(self.rate)
        sub_h = item.height * 3.0 / 7.0
        out = []
        for i, sub in enumerate(item):
            y = item.y if (i & 1) == 0 else item.y + item.height - sub_h
            out.append((sub, ((item.x + sub.x) / rate, y,
                              sub.length / rate, sub_h)))
        return out

    def unwatch(self):
        self.item.updated.disconnect(self._handle_updated)
        for name in ('item_added', 'items_removed', 'item_updated'):
            sig = getattr(self.item, name, None)
            if sig is not None:
                sig.disconnect(self._handle_sequence_changed)


class CanvasSceneModel:
    """Tracks a Space as a set of CanvasItemView objects
    (ui/canvas/scene.py role)."""

    def __init__(self, space):
        self.space = space
        self.views = {}
        self.changed = Signal()
        self.selection_changed = Signal()
        space.item_added.connect(self._handle_item_added)
        space.item_removed.connect(self._handle_item_removed)
        for item in space:
            self._handle_item_added(item)

    def _handle_item_added(self, item):
        self.views[id(item)] = CanvasItemView(self, item)
        self.changed()

    def _handle_item_removed(self, item):
        view = self.views.pop(id(item), None)
        if view:
            view.unwatch()
        self.changed()

    def item_changed(self, view):
        self.changed()

    def view_for(self, item):
        return self.views.get(id(item))

    # -- selection --------------------------------------------------------

    @property
    def selected_items(self):
        return [v.item for v in self.views.values() if v.selected]

    def select(self, items, extend=False):
        if not extend:
            for view in self.views.values():
                view.selected = False
        for item in items:
            view = self.view_for(item)
            if view:
                view.selected = True
        self.selection_changed()

    # -- hit testing ------------------------------------------------------

    def item_at(self, x_seconds, y, exclude=()):
        """Topmost (lowest z) item under the point; *exclude* skips
        items (e.g. the ones being dragged, so hit tests find the drop
        target underneath them)."""
        exclude = set(exclude)
        hits = []
        for view in self.views.values():
            if view.item in exclude:
                continue
            rx, ry, rw, rh = view.rect
            if rx <= x_seconds < rx + rw and ry <= y < ry + rh:
                hits.append(view.item)
        if not hits:
            return None
        return min(hits, key=lambda i: i.z)

    def snap_x(self, x_seconds, exclude=(), threshold=0.25):
        """Snap to nearby item edges (the view's snap-to-edges
        behavior); returns possibly-adjusted x in seconds."""
        best = None
        for view in self.views.values():
            if view.item in exclude:
                continue
            rx, ry, rw, rh = view.rect
            for edge in (rx, rx + rw):
                d = abs(edge - x_seconds)
                if d <= threshold and (best is None or d < best[0]):
                    best = (d, edge)
        return best[1] if best else x_seconds


class _RecordedCommand(UndoCommand):
    """Records an already-executed gesture command on an UndoStack:
    push() re-runs redo(), so the first redo is a no-op (the gesture
    applied the edits live, step by step)."""

    def __init__(self, inner):
        UndoCommand.__init__(self, inner.text())
        self.inner = inner
        self._first = True

    def redo(self):
        if self._first:
            self._first = False
            return
        self.inner.redo()

    def undo(self):
        self.inner.undo()


class DragController:
    """Drives an ItemManipulator through a pointer gesture
    (ui/canvas/scene.py drag-drop role): start -> move(s) -> drop/cancel.
    """

    def __init__(self, scene, undo_stack, transform=None):
        self.scene = scene
        self.undo_stack = undo_stack
        self.manipulator = None
        #: Optional ViewTransformModel: when set, space drags snap to
        #: nearby item edges and show a SnapMarker (the reference
        #: view's snap bars — previously built+painted but unwired).
        self.transform = transform

    def start(self, item, grab_x_seconds, grab_y):
        items = [item] + [i for i in self.scene.selected_items if i != item]
        self._dragged = frozenset(items)
        self.manipulator = ItemManipulator(items, grab_x_seconds, grab_y)
        self._moved = False

    def _snap(self, x_seconds):
        if self.transform is None:
            return x_seconds
        snapped = self.scene.snap_x(
            x_seconds, exclude=getattr(self, '_dragged', ()))
        self.transform.clear_markers()
        if snapped != x_seconds:
            self.transform.add_marker(SnapMarker('x', snapped))
        return snapped

    def move_to_space(self, x_seconds, y):
        if self.manipulator:
            x_seconds = self._snap(float(x_seconds))
            self.manipulator.set_space_item(self.scene.space, x_seconds, y)
            self._moved = True

    def move_to_sequence(self, sequence, x_seconds, y, operation='add'):
        if self.manipulator:
            self.manipulator.set_sequence_item(sequence, x_seconds, y,
                                               operation)
            self._moved = True

    def drop(self):
        if not self.manipulator:
            return None
        if not self._moved:
            # plain click-select: press + release with no motion is not
            # an edit — finishing an unengaged manipulator would build
            # an empty command (review find: crashed on clip click)
            self.cancel()
            return None
        try:
            command = self.manipulator.finish()
        except Exception:
            # a finish() that cannot complete (e.g. removed-from-space
            # without a valid add) must not leave the controller
            # mid-drag: roll the gesture back and clear state so the
            # next press starts clean
            try:
                self.manipulator.reset()
            except Exception:
                pass
            self.manipulator = None
            self._moved = False
            raise
        self.manipulator = None
        if self.transform is not None:
            self.transform.clear_markers()
        if command is not None:
            # Already executed; the stack only records it
            self.undo_stack.push(_RecordedCommand(command))
        return command

    def cancel(self):
        if self.manipulator:
            self.manipulator.reset()
            self.manipulator = None
        if self.transform is not None:
            self.transform.clear_markers()


class HandleDragController:
    """Edge-handle trim/resize gestures: the reference ClipItem's
    Left/Right/Top/BottomController drags (clip.py:241-345) with the
    handle zones of update_view_decorations (clip.py:446-451), plus
    sequence-item start/length trims for expanded sequences
    (sequence.py role), toolkit-independent.

    Protocol mirrors DragController: ``hit_test`` classifies a press
    into an edge zone, ``start``/``move`` apply incremental Adjust*
    commands live (merged reference-style into one undo entry),
    ``drop`` records the merged command on the stack, ``cancel`` rolls
    the gesture back. Steps the model refuses (NoRoomError) are
    skipped, leaving the item at the last legal position."""

    #: handle zone thickness in view pixels (reference view.handle_width)
    HANDLE_PX = 5.0
    #: smallest height a top/bottom drag may leave (the reference clamps
    #: at 20.0 of its pixel-scaled y units; our y units are lanes)
    MIN_HEIGHT = 0.2

    def __init__(self, scene, undo_stack, transform=None):
        self.scene = scene
        self.undo_stack = undo_stack
        self.transform = transform
        self.item = None
        self.edge = None
        self._command = None

    # -- hit testing -----------------------------------------------------

    def hit_test(self, x_seconds, y):
        """Return ``(item, edge)`` when the point falls inside an edge
        handle zone — edge in 'left'/'right'/'top'/'bottom' for space
        items, 'seq_left'/'seq_right' for sub-items of an expanded
        sequence (then item is the SequenceItem) — else None."""
        if self.transform is None:
            return None
        hx = self.HANDLE_PX / float(self.transform.pixels_per_second)
        hy = self.HANDLE_PX / float(self.transform.pixels_per_lane)
        item = self.scene.item_at(x_seconds, y)
        if item is None:
            return None
        view = self.scene.view_for(item)
        subs = view.sub_rects() if hasattr(view, 'sub_rects') else None
        if subs:
            for sub, (sx, sy, sw, sh) in subs:
                if sy <= y <= sy + sh:
                    if sx <= x_seconds <= sx + hx:
                        return (sub, 'seq_left')
                    if sx + sw - hx <= x_seconds <= sx + sw:
                        return (sub, 'seq_right')
            return None
        rx, ry, rw, rh = view.rect
        if rx <= x_seconds <= rx + hx:
            return (item, 'left')
        if rx + rw - hx <= x_seconds <= rx + rw:
            return (item, 'right')
        if ry <= y <= ry + hy:
            return (item, 'top')
        if ry + rh - hy <= y <= ry + rh:
            return (item, 'bottom')
        return None

    # -- gesture -----------------------------------------------------------

    def start(self, item, edge, x_seconds, y):
        self.item = item
        self.edge = edge
        self._x0 = float(x_seconds)
        self._y0 = float(y)
        self._command = None
        if edge in ('seq_left', 'seq_right'):
            seq = item.sequence
            self._rate = float(self.scene.space.rate(seq.type()))
        else:
            self._rate = float(self.scene.space.rate(item.type()))
        self._orig_x = item.x
        self._orig_length = item.length
        self._orig_y = getattr(item, 'y', 0.0)
        self._orig_height = getattr(item, 'height', 0.0)

    def _step(self, make_command):
        """Build + apply one incremental command, merging it into the
        gesture's command (the reference controllers' move() body)."""
        from canvas_tpu_torch.editor.model import commands as _commands
        try:
            command = make_command()
        except _commands.NoRoomError:
            return
        if command is None:
            return
        command.redo()
        if self._command is not None:
            self._command.mergeWith(command)
        else:
            self._command = command

    def move(self, x_seconds, y):
        if self.item is None:
            return
        from canvas_tpu_torch.editor import model
        item, edge = self.item, self.edge
        dxf = int(round((float(x_seconds) - self._x0) * self._rate))
        dy = float(y) - self._y0

        if edge == 'left':
            # cumulative target minus already-applied steps, clamped so
            # at least one frame of clip remains (clip.py:249-254)
            offset = min(dxf + self._orig_x - item.x, item.length - 1)
            self._step(lambda: model.AdjustClipStartCommand(item, offset)
                       if offset else None)
        elif edge == 'right':
            offset = max(dxf + self._orig_length - item.length,
                         1 - item.length)
            self._step(lambda: model.AdjustClipLengthCommand(item, offset)
                       if offset else None)
        elif edge == 'top':
            offset = min(dy + self._orig_y - item.y,
                         item.height - self.MIN_HEIGHT)
            self._step(lambda: model.AdjustClipTopCommand(item, offset)
                       if offset else None)
        elif edge == 'bottom':
            offset = max(dy + self._orig_height - item.height,
                         self.MIN_HEIGHT - item.height)
            self._step(lambda: model.AdjustClipHeightCommand(item, offset)
                       if offset else None)
        elif edge == 'seq_left':
            offset = min(dxf + self._orig_x - item.x, item.length - 1)
            self._step(lambda: model.AdjustSequenceItemStartCommand(
                item, offset) if offset else None)
        elif edge == 'seq_right':
            offset = max(dxf + self._orig_length - item.length,
                         1 - item.length)
            self._step(lambda: model.AdjustSequenceItemLengthCommand(
                item, offset) if offset else None)

    def drop(self):
        """Finish the gesture: record the merged command for undo."""
        command, self._command = self._command, None
        self.item = self.edge = None
        if command is not None:
            self.undo_stack.push(_RecordedCommand(command))
        return command

    def cancel(self):
        """Abort the gesture, rolling back every applied step."""
        command, self._command = self._command, None
        self.item = self.edge = None
        if command is not None:
            command.undo()


class AssetDragController:
    """Drag an asset from the asset list onto the canvas: the reference
    Scene.AssetAddManipulator plus its dragMove/dragLeave/dropEvent
    protocol (scene.py:36-105,219-353), toolkit-independent.

    enter() resolves the asset (bringing it online if needed — failures
    land in ``error``/``offline`` for the shell to report, the
    QMessageBox role), building one Clip per default stream with
    two-way anchors tying secondary streams to the first. move() places
    the clips live in the space (or inserts into a hovered sequence);
    leave() rolls everything back; drop() records one undo entry.

    Divergence from the reference, on purpose: stream defined_range
    endpoints are tested against None, not falsiness — the reference's
    ``if not start_pos`` treats the common start==0 as "unknown" and
    backs a 5-second clip off the END of the asset (x=-25 for a
    96-frame source), which reads as a bug — and a fully-defined range
    caps the default length at the asset's actual end."""

    DEFAULT_LENGTH_SECONDS = 5.0
    DEFAULT_HEIGHT = 1.0

    def __init__(self, scene, undo_stack, asset_list):
        self.scene = scene
        self.undo_stack = undo_stack
        self.asset_list = asset_list
        self.items = None
        self.error = None
        self.offline = False
        self._add_commands = None
        self._add_op = None
        self._manip = None

    def enter(self, asset_path):
        """Begin a drag of *asset_path*; True when clips are ready to
        place. On failure sets ``offline`` or ``error`` and returns
        False (the shell reports on drop, scene.py:314-330)."""
        import traceback

        from canvas_tpu_torch import process
        from canvas_tpu_torch.editor import model

        self.error = None
        self.offline = False
        self.items = None
        try:
            asset = self.asset_list[asset_path]
            if not asset.is_source:
                return False
            source = asset.get_source()
            if source.offline:
                source.bring_online()
                if source.offline:
                    self.offline = True
                    return False
        except Exception:
            self.error = traceback.format_exc()
            return False

        space = self.scene.space
        items, commands = [], []
        for i, stream in enumerate(source.get_default_streams()):
            rate = space.rate(stream.stream_type)
            start, end = stream.defined_range
            default_len = int(round(float(rate)
                                    * self.DEFAULT_LENGTH_SECONDS))
            if start is None:
                if end is None:
                    start, end = 0, default_len
                else:
                    start = int(end) - default_len
            elif end is None:
                end = int(start) + default_len
            else:
                end = min(int(end), int(start) + default_len)
            item = model.Clip(
                type=stream.stream_type,
                source=model.AssetStreamRef(asset_path=asset_path,
                                            stream=stream.name),
                x=int(start), offset=int(start),
                length=int(end) - int(start) + 1,
                y=i * self.DEFAULT_HEIGHT, height=self.DEFAULT_HEIGHT)
            if i:
                # secondary streams (audio under video) ride a two-way
                # anchor so later drags move them as a group
                offset_ns = (
                    process.get_frame_time(space.rate(item.type()),
                                           item.x)
                    - process.get_frame_time(space.rate(items[0].type()),
                                             items[0].x))
                item.update(anchor=model.Anchor(target=items[0],
                                                offset_ns=offset_ns,
                                                two_way=True))
            items.append(item)
            commands.append(model.InsertItemCommand(space, item, i))
        if not items:
            return False
        self.items = items
        self._add_commands = commands
        return True

    def _ensure_added(self):
        from canvas_tpu_torch.editor import model
        if self._add_op is None:
            self._add_op = model.CompoundCommand('Add asset to space',
                                                 self._add_commands)
            self._add_op.redo()
            rate = float(self.scene.space.rate(self.items[0].type()))
            self._manip = ItemManipulator(self.items,
                                          self.items[0].x / rate,
                                          self.DEFAULT_HEIGHT * 0.5)

    def move(self, x_seconds, y, sequence=None, operation='add'):
        """Place the pending clips under the cursor; a hovered
        *sequence* routes to sequence insertion (scene.py:268-276)."""
        if self.items is None:
            return
        self._ensure_added()
        if sequence is not None:
            self._manip.set_sequence_item(sequence, x_seconds, y,
                                          operation)
        else:
            self._manip.set_space_item(self.scene.space, x_seconds, y)

    def leave(self):
        """The drag left the canvas: roll back (scene.py:301-312)."""
        if self._manip is not None:
            self._manip.reset()
        if self._add_op is not None:
            self._add_op.undo()
        self._clear()

    def drop(self):
        """Finish: one undo entry covering insert + placement."""
        from canvas_tpu_torch.editor import model
        if self._add_op is None:
            # entered but never moved over the canvas
            self._clear()
            return None
        try:
            command = model.CompoundCommand(
                'Drag asset to canvas',
                [self._add_op, self._manip.finish()], done=True)
        except Exception:
            self.leave()
            raise
        self._clear()
        # already executed: CompoundCommand(done=True) makes push a no-op
        self.undo_stack.push(command)
        return command

    def _clear(self):
        self.items = None
        self._add_commands = None
        self._add_op = None
        self._manip = None


class ViewTransformModel:
    """Zoom/scroll math of the timeline view (ui/canvas/view.py:51-224):
    maps scene units (x seconds, y lanes) to pixels, wheel-zoom steps
    anchored at a point, playhead tracking, and the snap-marker overlay
    list. A paint layer applies the transform; the math lives here so
    headless tests cover it."""

    ZOOM_STEP = 2.0 ** 0.5

    def __init__(self, pixels_per_second=64.0, pixels_per_lane=24.0):
        self.pixels_per_second = float(pixels_per_second)
        self.pixels_per_lane = float(pixels_per_lane)
        self.scroll_x = 0.0            # seconds at the left edge
        self.scroll_y = 0.0            # lanes at the top edge
        self.markers = []              # foreground markers (snap bars...)
        self.changed = Signal()

    # -- mapping ----------------------------------------------------------

    def scene_to_view(self, x_seconds, y):
        return ((x_seconds - self.scroll_x) * self.pixels_per_second,
                (y - self.scroll_y) * self.pixels_per_lane)

    def view_to_scene(self, px, py):
        return (px / self.pixels_per_second + self.scroll_x,
                py / self.pixels_per_lane + self.scroll_y)

    # -- zoom/scroll -------------------------------------------------------

    def zoom(self, steps, anchor_px=0.0):
        """Wheel zoom: scale time around the pointer (view.py:172-187)."""
        anchor_seconds = self.view_to_scene(anchor_px, 0.0)[0]
        self.pixels_per_second *= self.ZOOM_STEP ** steps
        # keep the anchor under the pointer
        self.scroll_x = anchor_seconds - anchor_px / self.pixels_per_second
        self.changed()

    def scroll_by(self, dpx, dpy):
        self.scroll_x += dpx / self.pixels_per_second
        self.scroll_y += dpy / self.pixels_per_lane
        self.changed()

    def follow_playhead(self, frame, rate, view_width_px, margin=0.1):
        """Keep the playhead visible: scroll when it leaves the central
        band (the view's clock-follow behavior, view.py:114-158)."""
        t = frame / float(rate)
        left = self.scroll_x
        width = view_width_px / self.pixels_per_second
        if t < left or t > left + width * (1.0 - margin):
            self.scroll_x = t - width / 2.0
            self.changed()

    # -- markers -----------------------------------------------------------

    def add_marker(self, marker):
        self.markers.append(marker)
        self.changed()

    def clear_markers(self):
        if self.markers:
            self.markers = []
            self.changed()


class SnapMarker:
    """Foreground snap indicator (ui/canvas/markers.py
    HorizontalSnapMarker/VerticalSnapMarker): axis 'x' in seconds or
    'y' in lanes."""

    def __init__(self, axis, position):
        self.axis = axis
        self.position = position


def z_order_commands(items, direction):
    """Commands for bring-forward/send-back over a selection
    (view.py:279-318): one command per item, compounded when several
    are selected. Returns the single command to push."""
    from canvas_tpu_torch.editor import model as model_mod
    if not items:
        return None
    cls = (model_mod.BringItemForwardCommand if direction == 'forward'
           else model_mod.SendItemBackCommand)
    if len(items) == 1:
        return cls(items[0])
    name = ('Bring items forward' if direction == 'forward'
            else 'Send items back')
    return model_mod.CompoundCommand(name, [cls(i) for i in items])
