"""Audio graph manager: Space -> process.AudioWorkspace.

Behavioral rebuild of the reference's fluggo/editor/graph/audio.py:23-103.
"""

from canvas_tpu_torch import process
from canvas_tpu_torch.audio import AudioSource
from canvas_tpu_torch.editor import plugins
from canvas_tpu_torch.editor.graph.common import (GEOMETRY_KEYS,
                                            apply_geometry_update,
                                            forward_stream_dirty)
from canvas_tpu_torch.editor.model import items as model_items
from canvas_tpu_torch.editor.model.connectors import AudioSourceRefConnector

__all__ = ['SpaceAudioManager', 'SequenceAudioManager']


class _FadeEnvelope(AudioSource):
    """Linear crossfade envelope for one sequence clip, applied in the
    clip's SOURCE sample coordinates (the workspace item rebases before
    pulling). ``fade_in = (start, length)`` scales sample start+k by
    k/length; ``fade_out`` by 1 - k/length — the same LINEAR ramp the
    video sequence's mix curve uses, so A/V transitions stay aligned
    and simultaneous ramps sum to unity."""

    def __init__(self, source):
        self.source = source
        self.fade_in = None
        self.fade_out = None

    def _render(self, frame):
        import numpy as np
        self.source._render(frame)
        if (self.fade_in is None and self.fade_out is None) or frame.empty:
            return
        lo, hi = frame.current_min_sample, frame.current_max_sample
        scaled = None
        for region, rising in ((self.fade_in, True), (self.fade_out, False)):
            if not region or region[1] <= 0:
                continue
            start, length = region
            a = max(lo, start)
            b = min(hi, start + length - 1)
            if a > b:
                continue
            if scaled is None:
                # copy-then-assign: upstream may have handed out a
                # cached/aliased buffer (the pull path's ghost-view
                # copy-back handles the re-assignment)
                scaled = np.array(frame.data, dtype=np.float32, copy=True)
            k = np.arange(a - start, b - start + 1, dtype=np.float32)
            gain = k / length if rising else 1.0 - k / length
            rows = slice(a - frame.full_min_sample,
                         b - frame.full_min_sample + 1)
            scaled[rows] *= gain[:, None]
        if scaled is not None:
            frame.data = scaled


class SequenceAudioManager(plugins.AudioStream):
    """Compiles an audio model Sequence into an AudioWorkspace.

    The reference leaves this unimplemented
    (graph/audio.py:84 'Need a SequenceAudioManager here'); this build
    completes it: each sequence item is placed at its absolute sample
    position and transitions CROSSFADE — the outgoing clip ramps out
    while the incoming clip ramps in over the overlap, matching the
    video sequence's linear mix curve (additive sum of the two ramps).
    """

    class ItemWatcher:
        def __init__(self, owner, seq_item, workspace_item, stream,
                     envelope):
            self.owner = owner
            self.seq_item = seq_item
            self.workspace_item = workspace_item
            self.stream = stream
            self.envelope = envelope
            stream.frames_updated.connect(self.handle_stream_frames)

        def handle_stream_frames(self, *args):
            forward_stream_dirty(self.owner.frames_updated,
                                 self.workspace_item, *args)

        def unwatch(self):
            self.stream.frames_updated.disconnect(self.handle_stream_frames)

    def __init__(self, sequence, source_list, format):
        self.workspace = process.AudioWorkspace()
        plugins.AudioStream.__init__(self, self.workspace, format)

        self.sequence = sequence
        self.source_list = source_list
        self.sequence.item_added.connect(self._handle_item_added)
        self.sequence.items_removed.connect(self._handle_items_removed)
        self.sequence.item_updated.connect(self._handle_item_updated)
        self.watchers = {}

        for item in self.sequence:
            self._handle_item_added(item)

    def unwatch(self):
        self.sequence.item_added.disconnect(self._handle_item_added)
        self.sequence.items_removed.disconnect(self._handle_items_removed)
        self.sequence.item_updated.disconnect(self._handle_item_updated)
        for watcher in self.watchers.values():
            watcher.unwatch()

    def _handle_item_added(self, item):
        stream = AudioSourceRefConnector(self.source_list, item.source,
                                         model_obj=item)
        self.follow_alerts(stream)
        envelope = _FadeEnvelope(stream)
        workspace_item = self.workspace.add(
            x=item.x, length=item.length, offset=item.offset,
            source=envelope)
        self.watchers[id(item)] = self.ItemWatcher(self, item,
                                                   workspace_item, stream,
                                                   envelope)
        self._resync_and_fire(item.x, item.x + item.length - 1)

    def _handle_items_removed(self, start, stop):
        live = {id(item) for item in self.sequence}
        dirty_lo, dirty_hi = None, None
        for watcher in self.watchers.values():
            ws = watcher.workspace_item
            hi = ws.x + ws.length - 1
            dirty_hi = hi if dirty_hi is None else max(dirty_hi, hi)
        for key in list(self.watchers):
            if key not in live:
                watcher = self.watchers.pop(key)
                watcher.unwatch()
                self.unfollow_alerts(watcher.stream)
                ws = watcher.workspace_item
                dirty_lo = ws.x if dirty_lo is None else min(dirty_lo, ws.x)
                self.workspace.remove(ws)
        # The predecessor's fade-out envelope changes too (it now
        # crossfades into the removal's successor, whose transition may
        # reach further left than the removed clip's did) — its whole
        # span joins the dirty range.
        if dirty_lo is not None and 0 < start <= len(self.sequence):
            pred = self.watchers.get(id(self.sequence[start - 1]))
            if pred is not None:
                dirty_lo = min(dirty_lo, pred.workspace_item.x)
        self._resync()
        if dirty_lo is not None and dirty_hi is not None:
            # Everything from the first removed clip to the old end of
            # the sequence may have shifted.
            self.frames_updated(dirty_lo, max(dirty_lo, dirty_hi))

    def _handle_item_updated(self, item, **kw):
        watcher = self.watchers.get(id(item))
        if watcher is None:
            return
        # The model fires a bare x= notification for every clip an edit
        # shifts; the primary edit's _resync_and_fire already walked all
        # of them (it diffs ws-vs-model geometry), so reacting to each
        # would make one edit O(n^2) and flood the planner with ranges.
        if GEOMETRY_KEYS.isdisjoint(kw):
            return
        if 'source' in kw and watcher.stream.ref != item.source:
            watcher.stream.set_ref(item.source)
        self._resync_and_fire(item.x, item.x + item.length - 1)

    def _workspace_end(self):
        return max((w.workspace_item.x + w.workspace_item.length - 1
                    for w in self.watchers.values()), default=0)

    def _resync_and_fire(self, anchor_lo, anchor_hi):
        """Push model geometry into the workspace and fire ONE dirty
        range covering everything that moved.

        The model shifts following clips without firing item_updated
        for them, so the shifted set is inferred by diffing each
        watcher's workspace geometry (still pre-edit here) against its
        model item; the range runs from the earliest difference to the
        old-or-new end of the sequence."""
        lo = anchor_lo
        hi = max(anchor_hi, self._workspace_end())
        for w in self.watchers.values():
            ws, it = w.workspace_item, w.seq_item
            if (ws.x, ws.length, ws.offset) != (it.x, it.length, it.offset):
                lo = min(lo, ws.x, it.x)
        self._resync()
        self.frames_updated(lo, max(hi, self._workspace_end()))

    def _resync(self):
        items = list(self.sequence)
        for index, item in enumerate(items):
            watcher = self.watchers.get(id(item))
            if watcher is None:
                continue
            watcher.workspace_item.update(x=item.x, length=item.length,
                                          offset=item.offset)
            # Crossfade regions in SOURCE coordinates: ramp in over this
            # item's own transition, ramp out over the NEXT item's.
            tl = item.transition_length
            watcher.envelope.fade_in = ((item.offset, tl) if tl > 0
                                        else None)
            next_tl = (items[index + 1].transition_length
                       if index + 1 < len(items) else 0)
            watcher.envelope.fade_out = (
                (item.offset + item.length - next_tl, next_tl)
                if next_tl > 0 else None)


class SpaceAudioManager(plugins.AudioStream):
    class ItemWatcher:
        def __init__(self, owner, canvas_item, workspace_item, stream):
            self.owner = owner
            self.canvas_item = canvas_item
            self.workspace_item = workspace_item
            self.canvas_item.updated.connect(self.handle_updated)
            self.stream = stream
            if hasattr(stream, 'frames_updated'):
                stream.frames_updated.connect(self.handle_stream_frames)

        def handle_updated(self, **kw):
            apply_geometry_update(self.workspace_item,
                                  self.owner.frames_updated, **kw)
            if ('source' in kw and hasattr(self.stream, 'set_ref')
                    and self.stream.ref != self.canvas_item.source):
                # In-place source swap on a space clip — mirror the
                # video watcher (see _SpaceItemWatcher.handle_updated).
                self.stream.set_ref(self.canvas_item.source)

        def handle_stream_frames(self, *args):
            forward_stream_dirty(self.owner.frames_updated,
                                 self.workspace_item, *args)

        def unwatch(self):
            self.canvas_item.updated.disconnect(self.handle_updated)
            if hasattr(self.stream, 'frames_updated'):
                self.stream.frames_updated.disconnect(
                    self.handle_stream_frames)
            # Nested SequenceAudioManager: stop watching its model
            # Sequence (see the video watcher's note).
            if hasattr(self.stream, 'unwatch'):
                self.stream.unwatch()

    def __init__(self, canvas_space, source_list):
        self.workspace = process.AudioWorkspace()
        plugins.AudioStream.__init__(self, self.workspace,
                                     canvas_space.audio_format)

        self.canvas_space = canvas_space
        self.canvas_space.item_added.connect(self.handle_item_added)
        self.canvas_space.item_removed.connect(self.handle_item_removed)
        self.source_list = source_list
        self.watchers = {}

        for item in canvas_space:
            if item.type() == 'audio':
                self.handle_item_added(item)

    def unwatch(self):
        """Detach from the model entirely (see SpaceVideoManager)."""
        self.canvas_space.item_added.disconnect(self.handle_item_added)
        self.canvas_space.item_removed.disconnect(self.handle_item_removed)
        for watcher in self.watchers.values():
            watcher.unwatch()
        self.watchers.clear()

    def handle_item_added(self, item):
        if not isinstance(item, model_items.Item):
            return
        if item.type() != 'audio':
            return

        stream = None
        offset = 0
        if isinstance(item, model_items.Sequence):
            stream = SequenceAudioManager(item, self.source_list,
                                          self.format)
        elif hasattr(item, 'source'):
            stream = AudioSourceRefConnector(self.source_list, item.source,
                                             model_obj=item)
            offset = item.offset

        self.follow_alerts(stream)
        workspace_item = self.workspace.add(x=item.x, length=item.length,
                                            offset=offset, source=stream)
        watcher = self.ItemWatcher(self, item, workspace_item, stream)
        self.watchers[id(item)] = watcher
        self.frames_updated(item.x, item.x + item.length - 1)

    def handle_item_removed(self, item):
        if item.type() != 'audio':
            return
        watcher = self.watchers.pop(id(item))
        watcher.unwatch()
        self.unfollow_alerts(watcher.stream)
        ws_item = watcher.workspace_item
        span = (ws_item.x, ws_item.x + ws_item.length - 1)
        self.workspace.remove(ws_item)
        self.frames_updated(*span)
