"""Drag manipulators: interactive moves between space and sequences.

Behavioral rebuild of the reference's fluggo/editor/model/manip.py
(:36-750). A manipulator tracks one drag gesture: ``set_space_item`` /
``set_sequence_item`` tentatively apply commands as the pointer moves
(backing out previous placements), ``reset`` abandons the gesture, and
``finish`` returns one CompoundCommand for the undo stack.

Units: manipulator x inputs are floats in frames of the relevant rate
(ItemManipulator's public x is in seconds); command x values are integers
in the item's native rate.
"""

import itertools

from canvas_tpu_torch import logging as _logging
from canvas_tpu_torch.editor.model.commands import (
    AddOverlapItemsToSequenceCommand, AddSequenceToSequenceCommand,
    CompoundCommand, MoveItemCommand, MoveSequenceItemsInPlaceCommand,
    MoveSequenceOverlapItemsInPlaceCommand, NoRoomError,
    RemoveAdjacentItemsFromSequenceCommand, RemoveItemCommand,
    InsertItemCommand, SequenceItemsMover, SequenceOverlapItemsMover,
    UpdateItemPropertiesCommand)
from canvas_tpu_torch.editor.model.items import (Anchor, Clip, Item, Sequence,
                                           SequenceItem)

_log = _logging.getLogger(__name__)

__all__ = ['ClipManipulator', 'SequenceItemGroupManipulator',
           'SequenceManipulator', 'ItemManipulator']


class _SpaceToSequenceMixin:
    """Shared machinery for manipulators that move a space item into a
    sequence (ClipManipulator and SequenceManipulator differ only in the
    mover they build and the add command they use)."""

    def _make_mover(self):
        raise NotImplementedError

    def _make_add_op(self, sequence, target_x):
        raise NotImplementedError

    def _init_ops(self):
        self.space_move_op = None
        self.swap_anchor_op = None
        self.seq_mover = None
        self.seq_item = None
        self.space_remove_op = None
        self.seq_add_op = None
        self.seq_move_op = None

    def _move_in_space(self, space, x, y):
        self._undo_sequence()

        target_x = int(round(float(x) + self.offset_x))
        target_y = y + self.offset_y

        anchor = self.item.anchor
        if not anchor and not self.ignore_anchor:
            target = self.item.anchor_target
            if target:
                # Synthesize the reverse of the two-way anchor
                anchor = Anchor(target=target,
                                offset_ns=-target.anchor.offset_ns)
                anchor.y_offset = -target.anchor.y_offset

        if anchor and not self.ignore_anchor:
            target_x = anchor.get_desired_x(self.item)
            target_y = anchor.get_desired_y()

        space_move_op = MoveItemCommand(self.item, x=target_x, y=target_y)
        space_move_op.redo()

        if self.space_move_op:
            self.space_move_op.mergeWith(space_move_op)
        else:
            self.space_move_op = space_move_op

        return float(target_x) - self.offset_x

    def _move_in_place_command(self):
        raise NotImplementedError

    def _move_to_sequence(self, sequence, x, operation):
        if self.seq_mover is None:
            self._make_mover()

        target_x = int(round(float(x) + self.offset_x))

        if operation != 'add':
            raise ValueError(
                'Unsupported operation "{0}"'.format(operation))

        if self.seq_item.sequence == sequence:
            # Already in this sequence: slide in place
            offset = target_x - (sequence.x + self.seq_item.x)
            try:
                command = self._move_in_place_command(offset)
                command.redo()
                if self.seq_move_op:
                    self.seq_move_op.mergeWith(command)
                else:
                    self.seq_move_op = command
                return float(target_x) - self.offset_x
            except NoRoomError:
                pass        # back out and re-add below

        if self.seq_item.sequence:
            self._undo_sequence(undo_remove=False)

        if self.item.space:
            anchored = frozenset(
                self.item.space.find_immediate_anchored_items(self.item))

            space_remove_op = RemoveItemCommand(self.item.space, self.item)
            space_remove_op.redo()
            self.space_remove_op = space_remove_op

            if anchored:
                anchor_commands = []
                for item in anchored:
                    if not item.anchor:
                        # Found via our own two-way anchor; already right
                        continue
                    new_anchor = item.anchor.clone(target=self.seq_item)
                    command = UpdateItemPropertiesCommand(item,
                                                          anchor=new_anchor)
                    command.redo()
                    anchor_commands.append(command)
                self.swap_anchor_op = CompoundCommand(
                    'Swap anchors', anchor_commands, done=True)

        # Raises NoRoomError if there's nowhere to put it — the caller
        # must know finish() would fail
        self.seq_add_op = self._make_add_op(sequence, target_x)
        self.seq_add_op.redo()
        self.seq_move_op = None
        return float(target_x) - self.offset_x

    def _undo_sequence(self, undo_remove=True):
        if self.seq_move_op:
            self.seq_move_op.undo()
            self.seq_move_op = None
        if self.seq_add_op:
            self.seq_add_op.undo()
            self.seq_add_op = None
        # The anchor swap belongs WITH the space removal (both exist
        # iff the item left the space, and followers' anchors target
        # self.seq_item, which every re-add reuses): undoing it on a
        # partial back-out (undo_remove=False) left followers anchored
        # to a space-less item, and nothing recreated the swap.
        if undo_remove and self.swap_anchor_op:
            self.swap_anchor_op.undo()
            self.swap_anchor_op = None
        if undo_remove and self.space_remove_op:
            self.space_remove_op.undo()
            self.space_remove_op = None

    def reset(self):
        self._undo_sequence()
        if self.space_move_op:
            self.space_move_op.undo()
            self.space_move_op = None
        self.item.update(in_motion=False)

    def _finish_commands(self):
        if self.space_remove_op and not self.seq_add_op:
            raise RuntimeError('Not in a valid state to finish operation.')

        self.item.update(in_motion=False)

        if self.space_move_op and not self.space_remove_op:
            return CompoundCommand(self.space_move_op.text(),
                                   [self.space_move_op], done=True)

        commands = []
        if self.space_move_op:
            commands.append(self.space_move_op)
        commands.append(self.space_remove_op)
        if self.swap_anchor_op:
            commands.append(self.swap_anchor_op)
        commands.append(self.seq_add_op)
        if self.seq_move_op:
            commands.append(self.seq_move_op)
        return CompoundCommand(self.seq_add_op.text(), commands, done=True)


class ClipManipulator(_SpaceToSequenceMixin):
    """Manipulates a lone clip (manip.py:36-219)."""

    def __init__(self, item, grab_x, grab_y, ignore_anchor=False):
        self.item = item
        self.original_x = item.x
        self.original_y = item.y
        self.original_space = item.space
        self.offset_x = float(item.x) - float(grab_x)
        self.offset_y = item.y - grab_y
        self.ignore_anchor = ignore_anchor
        self.item.update(in_motion=True)
        self._init_ops()

    def type(self):
        return self.item.type()

    def _make_mover(self):
        self.seq_mover = SequenceOverlapItemsMover.from_clip(self.item)
        self.seq_item = self.seq_mover.items[0]

    def _make_add_op(self, sequence, target_x):
        return AddOverlapItemsToSequenceCommand(sequence, self.seq_mover,
                                                target_x)

    def _move_in_place_command(self, offset):
        return MoveSequenceOverlapItemsInPlaceCommand(self.seq_mover, offset)

    def set_space_item(self, space, x, y):
        return self._move_in_space(space, x, y)

    def set_sequence_item(self, sequence, x, operation):
        return self._move_to_sequence(sequence, x, operation)

    def finish(self):
        result = self._finish_commands()
        if self.seq_item:
            self.seq_item.update(in_motion=False)
        return result


class SequenceManipulator(_SpaceToSequenceMixin):
    """Manipulates an entire existing sequence (manip.py:376-551)."""

    def __init__(self, item, grab_x, grab_y, ignore_anchor=False):
        self.item = item
        self.original_x = item.x
        self.original_y = item.y
        self.original_space = item.space
        self.offset_x = item.x - grab_x
        self.offset_y = item.y - grab_y
        self.ignore_anchor = ignore_anchor
        self.item.update(in_motion=True)
        self._init_ops()

    def type(self):
        return self.item.type()

    def _make_mover(self):
        self.seq_mover = SequenceItemsMover(list(self.item))
        self.seq_item = self.seq_mover.overlap_movers[0].items[0]

    def _make_add_op(self, sequence, target_x):
        return AddSequenceToSequenceCommand(sequence, self.seq_mover,
                                            target_x)

    def _move_in_place_command(self, offset):
        return MoveSequenceItemsInPlaceCommand(self.seq_mover, offset)

    def set_space_item(self, space, x, y):
        return self._move_in_space(space, x, y)

    def set_sequence_item(self, sequence, x, operation):
        return self._move_to_sequence(sequence, x, operation)

    def finish(self):
        result = self._finish_commands()
        if self.seq_mover:
            for mover in self.seq_mover.overlap_movers:
                for item in mover.items:
                    item.update(in_motion=False)
        return result


class SequenceItemGroupManipulator:
    """Manipulates a set of items within one sequence (manip.py:221-374):
    sliding in place, or extracting them into a new space item and
    delegating to a Clip/Sequence manipulator."""

    def __init__(self, items, grab_x, grab_y):
        self.items = items
        self.mover = SequenceItemsMover(items)
        self.original_sequence = items[0].sequence
        self.original_x = items[0].x + self.original_sequence.x
        self.offset_x = float(self.original_x) - float(grab_x)
        self.offset_y = self.original_sequence.y - grab_y
        self.space_item = None
        self.length = items[-1].x + items[-1].length - items[0].x
        self.remove_command = None
        self.space_insert_command = None
        self.swap_anchor_op = None
        self.seq_move_op = None
        self.seq_manip = None

        for item in self.items:
            item.update(in_motion=True)

    def type(self):
        return self.original_sequence.type()

    def set_space_item(self, space, x, y):
        target_x = int(round(float(x) + self.offset_x))

        if self.seq_move_op:
            self.seq_move_op.undo()
            self.seq_move_op = None

        if not self.seq_manip:
            self.space_item = self.mover.to_item(
                x=target_x, y=y + self.offset_y,
                height=self.original_sequence.height)

            # If it collapses to a clip, retarget anchors to it
            if isinstance(self.space_item, Clip):
                anchored = frozenset(
                    self.original_sequence.space
                    .find_immediate_anchored_items(self.items[0]))
                if anchored:
                    anchor_commands = []
                    for item in anchored:
                        new_anchor = item.anchor.clone(
                            target=self.space_item)
                        anchor_commands.append(UpdateItemPropertiesCommand(
                            item, anchor=new_anchor))
                    self.swap_anchor_op = CompoundCommand(
                        'Swap anchors', anchor_commands, done=False)

            self.remove_command = RemoveAdjacentItemsFromSequenceCommand(
                self.items)
            self.remove_command.redo()

            if self.swap_anchor_op:
                self.swap_anchor_op.redo()

            self.space_insert_command = InsertItemCommand(
                space, self.space_item, self.original_sequence.z)
            self.space_insert_command.redo()

            if isinstance(self.space_item, Clip):
                self.seq_manip = ClipManipulator(
                    self.space_item, float(target_x) - self.offset_x, y)
            else:
                self.seq_manip = SequenceManipulator(
                    self.space_item, float(target_x) - self.offset_x, y)

        return self.seq_manip.set_space_item(space, x, y)

    def set_sequence_item(self, sequence, x, operation):
        if self.seq_manip:
            return self.seq_manip.set_sequence_item(sequence, x, operation)

        target_x = int(round(float(x) + self.offset_x))

        if operation == 'add' and self.items[0].sequence == sequence:
            offset = target_x - (sequence.x + self.items[0].x)
            try:
                command = MoveSequenceItemsInPlaceCommand(self.mover, offset)
                command.redo()
                if self.seq_move_op:
                    self.seq_move_op.mergeWith(command)
                else:
                    self.seq_move_op = command
                return float(target_x) - self.offset_x
            except NoRoomError:
                pass

        self.set_space_item(sequence.space, 0, 0)
        return self.seq_manip.set_sequence_item(sequence, x, operation)

    def reset(self):
        if self.seq_manip:
            self.seq_manip.reset()
            self.seq_manip = None
        if self.space_insert_command:
            self.space_insert_command.undo()
            self.space_insert_command = None
        if self.swap_anchor_op:
            self.swap_anchor_op.undo()
            self.swap_anchor_op = None
        if self.remove_command:
            self.remove_command.undo()
            self.remove_command = None
        if self.seq_move_op:
            self.seq_move_op.undo()
            self.seq_move_op = None
        for item in self.items:
            item.update(in_motion=False)

    def finish(self):
        for item in self.items:
            item.update(in_motion=False)

        if not self.seq_manip and not self.seq_move_op:
            return None

        if self.seq_move_op and not self.seq_manip:
            return CompoundCommand(self.seq_move_op.text(),
                                   [self.seq_move_op], done=True)

        commands = []
        if self.seq_move_op:
            commands.append(self.seq_move_op)
        seq_command = self.seq_manip.finish()
        commands.append(self.remove_command)
        if self.swap_anchor_op:
            commands.append(self.swap_anchor_op)
        commands.append(self.space_insert_command)
        commands.append(seq_command)
        return CompoundCommand(seq_command.text(), commands, done=True)


class ItemManipulator:
    """Moves a mixed selection of clips, sequence items, and sequences
    (manip.py:553-750). The first item is primary (under the cursor);
    everything else, including anchored followers, is placed around it.
    Public x is in *seconds*."""

    def __init__(self, items, grab_x, grab_y):
        primary = items[0]
        space = primary.sequence.space if isinstance(primary, SequenceItem) \
            else primary.space
        self.space = space

        items = set(items)
        anchored_items = set(itertools.chain.from_iterable(
            space.find_anchored_items(target) for target in items))
        items.update(anchored_items)

        # Don't move a sequence's items separately if the sequence moves
        items.difference_update(frozenset(itertools.chain.from_iterable(
            seq for seq in items if isinstance(seq, Sequence))))

        if isinstance(primary, SequenceItem) and primary not in items:
            primary = primary.sequence

        # A SequenceItem primary stays in the set so the per-sequence
        # grouping below includes it in its OWN adjacency group —
        # removing it built the group from its siblings only, and the
        # grabbed item never moved (and a split selection produced a
        # non-adjacent group that raised mid-gesture).
        if not isinstance(primary, SequenceItem):
            items.remove(primary)

        seq_items = set(i for i in items if isinstance(i, SequenceItem))
        items = set(i for i in items if isinstance(i, Item))

        sequences = []
        for seq, itemlist in itertools.groupby(
                sorted(seq_items, key=lambda a: (id(a.sequence), a.index)),
                key=lambda a: a.sequence):
            list_ = list(itemlist)
            if len(seq) == len(list_):
                # The whole sequence: move it as a space item
                if isinstance(primary, SequenceItem) and \
                        primary.sequence == seq:
                    primary = SequenceManipulator(
                        seq, grab_x * float(space.rate(seq.type())), grab_y)
                else:
                    items.add(seq)
            else:
                mover = SequenceItemGroupManipulator(
                    list_, grab_x * float(space.rate(seq.type())), grab_y)
                if isinstance(primary, SequenceItem) and \
                        primary.sequence == seq:
                    primary = mover
                else:
                    sequences.append(mover)

        if isinstance(primary, Clip):
            primary = ClipManipulator(
                primary, grab_x * float(space.rate(primary.type())), grab_y,
                ignore_anchor=True)
        elif isinstance(primary, Sequence):
            primary = SequenceManipulator(
                primary, grab_x * float(space.rate(primary.type())), grab_y)
        elif isinstance(primary, SequenceItem):
            primary = SequenceItemGroupManipulator(
                [primary], grab_x * float(space.rate(primary.type())),
                grab_y)

        self.primary = primary
        self.sequences = sequences

        # Place anchored items after their targets
        seen = {primary}
        itemset = frozenset(items)
        self.items = []
        last_len = 0
        while len(self.items) != len(items):
            for item in items:
                if item in seen:
                    continue
                target = item.anchor_target
                if not target or target not in itemset or target in seen:
                    seen.add(item)
                    self.items.append(self._make_manip(item, grab_x,
                                                       grab_y))
            if len(self.items) == last_len:
                # Circular anchors: break one arbitrarily
                local = [i for i in items if i not in seen]
                item = local[0]
                seen.add(item)
                self.items.append(self._make_manip(item, grab_x, grab_y))
            last_len = len(self.items)

    def _make_manip(self, item, grab_x, grab_y):
        rate = float(self.space.rate(item.type()))
        if isinstance(item, Clip):
            return ClipManipulator(item, grab_x * rate, grab_y)
        return SequenceManipulator(item, grab_x * rate, grab_y)

    def set_space_item(self, space, x, y):
        x = float(x)
        if isinstance(self.primary, (ClipManipulator, SequenceManipulator)):
            target_x = self.primary.set_space_item(
                space, x * float(space.rate(self.primary.type())), y)
            x = float(target_x) / float(space.rate(self.primary.type()))

            for seq in self.sequences:
                try:
                    seq.set_sequence_item(
                        seq.original_sequence,
                        x * float(self.space.rate(seq.type())), 'add')
                except NoRoomError:
                    seq.set_space_item(
                        space, x * float(space.rate(seq.type())), y)
            for item in self.items:
                item.set_space_item(space,
                                    x * float(space.rate(item.type())), y)
        elif isinstance(self.primary, SequenceItemGroupManipulator):
            target_x = self.primary.set_space_item(
                space, x * float(space.rate(self.primary.type())), y)
            x = float(target_x) / float(space.rate(self.primary.type()))
            for seq in self.sequences:
                seq.set_space_item(space,
                                   x * float(space.rate(seq.type())), y)
            for item in self.items:
                item.set_space_item(space,
                                    x * float(space.rate(item.type())), y)

    def set_sequence_item(self, sequence, x, y, operation):
        x = float(x)
        try:
            target_x = self.primary.set_sequence_item(
                sequence,
                x * float(sequence.space.rate(self.primary.type())),
                operation)
            new_x = float(target_x) / float(
                sequence.space.rate(self.primary.type()))
            for seq in self.sequences:
                seq.set_space_item(
                    sequence.space,
                    new_x * float(sequence.space.rate(seq.type())), y)
            for item in self.items:
                item.set_space_item(
                    sequence.space,
                    new_x * float(sequence.space.rate(item.type())), y)
        except NoRoomError:
            self.set_space_item(sequence.space, x, y)

    def reset(self):
        self.primary.reset()
        for seq in self.sequences:
            seq.reset()
        for item in self.items:
            item.reset()

    def finish(self):
        commands = []
        text = 'Move item'

        primary_command = self.primary.finish()
        if primary_command:
            commands.append(primary_command)
            text = primary_command.text()

        commands.extend(c for c in (s.finish() for s in self.sequences) if c)
        commands.extend(c for c in (i.finish() for i in self.items) if c)

        if not commands:
            return None
        return CompoundCommand(text, commands, done=True)
