"""Video graph managers: compile Space/Sequence models into the engine.

Behavioral rebuild of the reference's fluggo/editor/graph/video.py:
``SpaceVideoManager`` (:32-130) mirrors a Space into a
process.VideoWorkspace and keeps z-order in sync with the y/z sort;
``SequenceVideoManager`` (:132-293) compiles a Sequence into a
process.VideoSequence whose per-clip streams mix in the *next* clip's
transition through an AnimationFunc-driven VideoMixFilter. Both push
model edits into the engine and publish ``frames_updated`` dirty ranges.
"""

from canvas_tpu_torch import process
from canvas_tpu_torch.editor import plugins
from canvas_tpu_torch.editor.graph.common import (GEOMETRY_KEYS,
                                            apply_geometry_update,
                                            forward_stream_dirty)
from canvas_tpu_torch.editor.model import items as model_items
from canvas_tpu_torch.editor.model.connectors import VideoSourceRefConnector

__all__ = ['SpaceVideoManager', 'SequenceVideoManager']


def _stack_z(item):
    """Composite stacking key for a model item, as a workspace z value
    (larger = on top): above anything in a lower lane (smaller y on
    top), and within a lane by model z (smaller z on top). O(1) per
    item, no ordering structure."""
    return (-item.y, -item.z)


class _SpaceItemWatcher:
    """Tracks one model item inside a SpaceVideoManager."""

    def __init__(self, owner, canvas_item, workspace_item, stream):
        self.owner = owner
        self.canvas_item = canvas_item
        self.workspace_item = workspace_item
        self.stream = stream
        canvas_item.updated.connect(self.handle_updated)
        if hasattr(stream, 'frames_updated'):
            stream.frames_updated.connect(self.handle_stream_frames)

    def unwatch(self):
        self.canvas_item.updated.disconnect(self.handle_updated)
        if hasattr(self.stream, 'frames_updated'):
            self.stream.frames_updated.disconnect(self.handle_stream_frames)
        # A nested manager (Sequence inside the Space) keeps watching
        # its model object until told otherwise — a removed-then-
        # re-added Sequence would otherwise be processed by every dead
        # manager too.
        if hasattr(self.stream, 'unwatch'):
            self.stream.unwatch()

    def handle_stream_frames(self, *args):
        # Content changed INSIDE the item's stream (a sequence edit, a
        # source swap, an edit in a nested composition): rebase into
        # space frames and re-fire.
        forward_stream_dirty(self.owner.frames_updated,
                             self.workspace_item, *args)

    def handle_updated(self, **kw):
        apply_geometry_update(self.workspace_item,
                              self.owner.frames_updated, **kw)
        if ('source' in kw and hasattr(self.stream, 'set_ref')
                and self.stream.ref != self.canvas_item.source):
            # In-place source swap on a space clip (the reference's
            # watcher ignores these, graph/video.py:43-65 — a latent
            # stale-render there): re-resolve the connector; its
            # set_base_filter fires the dirty union, which
            # handle_stream_frames rebases into space frames.
            self.stream.set_ref(self.canvas_item.source)
        if 'z' in kw or 'y' in kw:
            ws_item = self.workspace_item
            key = _stack_z(self.canvas_item)
            if ws_item.z != key:
                ws_item.update(z=key)
                self.owner.frames_updated(ws_item.x,
                                          ws_item.x + ws_item.length - 1)


class SpaceVideoManager(plugins.VideoStream):
    """Space -> VideoWorkspace, kept live.

    Stacking order: items composite by the total key (y, z) — above
    anything in a lower lane (smaller y on top), and by model z within
    a lane — realized as workspace z = (-y, -z), an O(1) update per
    edit with no ordering structure. The reference incrementally
    maintained a SortedList keyed by ``z_sort_key`` — z within a
    transitive x∧y-overlap group, else y — but that comparator is
    intransitive (its pair rules admit cycles), so the incremental
    order could drift from what a fresh compile of the same document
    produces (found by tests/test_graph_fuzz.py: a saved project
    rendered differently than the live session). The (y, z) key keeps
    both intents — lane stacking between lanes, explicit z inside a
    lane — and only diverges for rectangles that overlap while
    straddling lanes, where it deterministically favors the higher
    lane."""

    ItemWatcher = _SpaceItemWatcher

    def __init__(self, canvas_space, source_list):
        self.workspace = process.VideoWorkspace()
        plugins.VideoStream.__init__(self, self.workspace,
                                     canvas_space.video_format)

        self.canvas_space = canvas_space
        self.source_list = source_list
        self.watchers = {}

        canvas_space.item_added.connect(self.handle_item_added)
        canvas_space.item_removed.connect(self.handle_item_removed)
        for item in canvas_space:
            if item.type() == 'video':
                self.handle_item_added(item)

    def unwatch(self):
        """Detach from the model entirely (space AND per-item signals):
        a Space taken offline/online would otherwise keep every dead
        manager processing edits (_SpaceSource.take_offline calls
        this)."""
        self.canvas_space.item_added.disconnect(self.handle_item_added)
        self.canvas_space.item_removed.disconnect(self.handle_item_removed)
        for watcher in self.watchers.values():
            watcher.unwatch()
        self.watchers.clear()

    def _build_stream(self, item):
        """Stream + source offset for a model item."""
        if isinstance(item, model_items.Sequence):
            return SequenceVideoManager(item, self.source_list,
                                        self.format), 0
        if hasattr(item, 'source'):
            connector = VideoSourceRefConnector(self.source_list,
                                                item.source, model_obj=item)
            return connector, item.offset
        return None, 0

    def handle_item_added(self, item):
        if not isinstance(item, model_items.Item) or item.type() != 'video':
            return
        stream, offset = self._build_stream(item)
        self.follow_alerts(stream)
        ws_item = self.workspace.add(x=item.x, length=item.length,
                                     z=_stack_z(item), offset=offset,
                                     source=stream)
        watcher = self.ItemWatcher(self, item, ws_item, stream)
        self.watchers[id(item)] = watcher
        # The reference fires nothing here; ranged invalidation needs
        # the new item's span reported (see forward_stream_dirty).
        self.frames_updated(item.x, item.x + item.length - 1)

    def handle_item_removed(self, item):
        if item.type() != 'video':
            return
        watcher = self.watchers.pop(id(item))
        watcher.unwatch()
        self.unfollow_alerts(watcher.stream)
        ws_item = watcher.workspace_item
        span = (ws_item.x, ws_item.x + ws_item.length - 1)
        self.workspace.remove(ws_item)
        self.frames_updated(*span)


class _SequenceClipStream(plugins.VideoStream):
    """The engine graph for one sequence clip: the clip itself plus its
    *out* transition into the next clip, and any gap before it.

    Graph shape (reference graph/video.py:133-163):

        connector -> source_a (trims/offsets the clip)
                  -> gap_proxy (shifts for a leading gap)
        next clip's connector -> source_b
        mix(gap_proxy, source_b, mix_curve)

    The mix curve holds 0 until ``fade_point`` then ramps to 1 by
    ``out_point`` — a crossfade whose endpoints the manager retimes as
    lengths and transitions change.
    """

    def __init__(self, owner, seq_item):
        self.owner = owner
        self.seq_item = seq_item
        self.connector = VideoSourceRefConnector(
            owner.source_list, ref=seq_item.source, model_obj=seq_item)

        self.source_a = process.VideoPassThroughFilter(self.connector,
                                                       start_frame=0)
        self.gap_proxy = process.VideoPassThroughFilter(self.source_a)
        self.source_b = process.VideoPassThroughFilter(None)

        self.mix_curve = process.AnimationFunc()
        self.mix_curve.add(process.POINT_HOLD, -1.0, 0.0)
        self.fade_point = self.mix_curve.add(process.POINT_LINEAR, 0.0, 0.0)
        self.out_point = self.mix_curve.add(process.POINT_HOLD, 0.0, 1.0)

        mixer = process.VideoMixFilter(self.gap_proxy, self.source_b,
                                       self.mix_curve)
        plugins.VideoStream.__init__(self, mixer)
        self.follow_alerts(self.connector)
        self.connector.frames_updated.connect(self._forward_content_dirty)

    def unwatch(self):
        self.connector.frames_updated.disconnect(self._forward_content_dirty)

    def _forward_content_dirty(self, *args):
        """A content edit inside this clip's source: rebase into
        sequence frames. Source sample s shows at f = s - offset + x,
        and model SequenceItem.x ALREADY includes the transition shift
        (items.py _move_items), so the clip's full visible span —
        fading in through the previous clip's out-transition and out
        through the next's — is exactly [x, x + length - 1]."""
        item = self.seq_item
        lo, hi = args[-2], args[-1]
        x0 = item.x
        x1 = item.x + item.length - 1
        lo = x0 if lo is None else int(lo) - item.offset + item.x
        hi = x1 if hi is None else int(hi) - item.offset + item.x
        lo = max(lo, x0)
        hi = min(hi, x1)
        if lo <= hi:
            self.owner.frames_updated(lo, hi)


class SequenceVideoManager(plugins.VideoStream):
    """Sequence -> VideoSequence of per-clip crossfading streams."""

    ItemWatcher = _SequenceClipStream

    def __init__(self, sequence, source_list, format):
        self.seqfilter = process.VideoSequence()
        plugins.VideoStream.__init__(self, self.seqfilter, format)

        self.sequence = sequence
        self.source_list = source_list
        self.watchers = []

        sequence.item_added.connect(self._handle_item_added)
        sequence.items_removed.connect(self._handle_items_removed)
        sequence.item_updated.connect(self._handle_item_updated)
        for item in sequence:
            self._handle_item_added(item)

    def unwatch(self):
        self.sequence.item_added.disconnect(self._handle_item_added)
        self.sequence.items_removed.disconnect(self._handle_items_removed)
        self.sequence.item_updated.disconnect(self._handle_item_updated)
        for watcher in self.watchers:
            watcher.unwatch()

    # -- neighbors --------------------------------------------------------

    def _watcher_at(self, index):
        if 0 <= index < len(self.watchers):
            return self.watchers[index]
        return None

    def _handle_item_added(self, item):
        watcher = self.ItemWatcher(self, item)
        self.follow_alerts(watcher)
        self.watchers.insert(item.index, watcher)
        self.seqfilter.insert(item.index, (watcher, 0, item.length))

        self._handle_item_updated(item, offset=item.offset,
                                  source=item.source, length=item.length,
                                  transition_length=item.transition_length)
        # (_handle_item_updated's 'following' branch already aimed this
        # item's source_b at the next clip's connector + offset)

    def _handle_items_removed(self, start, stop):
        dirty_lo = self.watchers[start].seq_item.x
        dirty_hi = (self.seqfilter.get_start_frame(len(self.seqfilter) - 1) +
                    self.seqfilter[-1][2] - 1)

        for watcher in self.watchers[start:stop]:
            self.unfollow_alerts(watcher)
            watcher.unwatch()
        del self.watchers[start:stop]
        for index in reversed(range(start, stop)):
            del self.seqfilter[index]

        successor = self._watcher_at(start)
        if successor:
            item = successor.seq_item
            self._handle_item_updated(
                item, transition_length=item.transition_length)
        elif self.watchers:
            # Removed the tail: the new last clip fades to nothing
            last = self.watchers[-1]
            last.source_b.set_source(None)
            last.fade_point.frame = (last.seq_item.length -
                                     last.seq_item.transition_length)

        self.frames_updated(dirty_lo, dirty_hi)

    def _handle_item_updated(self, item, **kw):
        if GEOMETRY_KEYS.isdisjoint(kw):
            return

        watcher = self.watchers[item.index]
        prev = self._watcher_at(item.index - 1)
        following = self._watcher_at(item.index + 1)

        start_frame = item.x + item.transition_length
        visible_len = item.length - item.transition_length
        mid_width = visible_len
        if following:
            mid_width -= following.seq_item.transition_length

        # Re-aim the retiming filters; cheap enough to do unconditionally
        if following:
            watcher.source_b.offset = (following.seq_item.offset -
                                       mid_width)
            watcher.source_b.set_source(following.connector)
        if prev:
            prev_item = prev.seq_item
            prev_len = prev_item.length - prev_item.transition_length
            prev.source_b.offset = item.offset - (
                prev_len - item.transition_length)
            prev.source_b.set_source(watcher.connector)
        watcher.source_a.offset = item.offset + max(0,
                                                    item.transition_length)
        watcher.gap_proxy.offset = min(0, item.transition_length)

        if 'offset' in kw:
            self.frames_updated(start_frame - item.transition_length,
                                start_frame + visible_len - 1)
        if 'source' in kw:
            # Reconnect only on a real change: set_ref re-resolves and
            # fires an unbounded invalidation through the content
            # forwarder, and the add path passes the ref the connector
            # was just constructed with.
            if watcher.connector.ref != item.source:
                watcher.connector.set_ref(item.source)
            self.frames_updated(start_frame - item.transition_length,
                                start_frame + visible_len - 1)

        if 'transition_length' in kw or 'length' in kw:
            old_fade = int(round(watcher.fade_point.frame))
            old_len = int(round(watcher.out_point.frame))

            watcher.out_point.frame = visible_len
            watcher.fade_point.frame = mid_width

            if 'transition_length' in kw and prev:
                prev_item = prev.seq_item
                prev_len = prev_item.length - prev_item.transition_length
                old_trans = int(round(prev.out_point.frame -
                                      prev.fade_point.frame))
                prev.out_point.frame = prev_len
                prev.fade_point.frame = prev_len - max(
                    item.transition_length, 0)
                self.frames_updated(
                    start_frame - item.transition_length -
                    max(old_trans - item.transition_length, 0),
                    self.sequence.length + max(0, old_len - visible_len) - 1)
            else:
                self.frames_updated(
                    start_frame + min(old_fade, mid_width),
                    self.sequence.length + max(0, old_len - visible_len) - 1)

            self.seqfilter[item.index] = (watcher, 0, visible_len)
