"""Undoable editing commands for the canvas model.

Behavioral rebuild of the reference's fluggo/editor/model/commands.py
(:29-1013) on the toolkit-free undo framework: the sequence movers,
placement math (determine_range/where_can_fit), in-place moves with
NoRoomError checking, removal/insertion, clip handle adjustments, and
z-order commands.
"""

import collections

from canvas_tpu_torch import logging as _logging
from canvas_tpu_torch.editor.model.items import Clip, Sequence, SequenceItem
from canvas_tpu_torch.editor.model.undo import UndoCommand

_log = _logging.getLogger(__name__)

__all__ = ['SequenceItemsMover', 'SequenceOverlapItemsMover', 'NoRoomError',
           'AddOverlapItemsToSequenceCommand', 'CompoundCommand',
           'UpdateItemPropertiesCommand', 'MoveItemCommand',
           'AddSequenceToSequenceCommand',
           'MoveSequenceOverlapItemsInPlaceCommand',
           'MoveSequenceItemsInPlaceCommand',
           'RemoveAdjacentItemsFromSequenceCommand', 'RemoveItemCommand',
           'InsertItemCommand', 'RemoveItemsFromSequenceCommand',
           'AdjustClipLengthCommand', 'AdjustClipStartCommand',
           'SlipBehindCommand', 'AdjustClipTopCommand',
           'AdjustClipHeightCommand', 'AdjustSequenceItemStartCommand',
           'AdjustSequenceItemLengthCommand', 'BringItemForwardCommand',
           'SendItemBackCommand',
           'UpdateSequenceItemPropertiesCommand',
           'InsertSequenceItemCommand', 'RemoveSequenceItemCommand',
           'AddClipCommand']

_Placement = collections.namedtuple('_Placement', 'min max index')


def _split_sequence_items_by_overlap(items):
    """Split index-sorted sequence items into runs that overlap (positive
    transition_length chains); runs can move independently."""
    if not items:
        return []
    next_list = [items[0]]
    result = [next_list]
    for item in items[1:]:
        if (item.index != next_list[-1].index + 1 or
                next_list[-1].transition_length >= 0):
            next_list = [item]
            result.append(next_list)
        else:
            next_list.append(item)
    return result


def _split_sequence_items_by_adjacency(items):
    """Split index-sorted items into runs of adjacent indexes."""
    if not items:
        return []
    next_list = [items[0]]
    result = [next_list]
    for item in items[1:]:
        if item.index != next_list[-1].index + 1:
            next_list = [item]
            result.append(next_list)
        else:
            next_list.append(item)
    return result


class SequenceOverlapItemsMover:
    """Mover for overlapping items of one sequence (commands.py:134-177)."""

    def __init__(self, items, offset=None):
        self.items = items
        self.offset = offset
        self.length = sum(
            items[i].length - (items[i].transition_length if i > 0 else 0)
            for i in range(len(items)))

        # Maximum transition_length the *next* item may take against us,
        # and the max fade-in the previous item may take
        self.max_fadeout_length = items[-1].length
        self.max_fadein_length = items[0].length
        if len(items) > 1:
            self.max_fadeout_length -= items[-1].transition_length
            self.max_fadein_length -= items[1].transition_length

    def clone_items(self):
        return [item.clone() for item in self.items]

    def clone(self):
        return SequenceOverlapItemsMover(self.clone_items(),
                                         offset=self.offset)

    @classmethod
    def from_clip(cls, clip):
        seq_item = SequenceItem(source=clip.source, length=clip.length,
                                offset=clip.offset, transition_length=0,
                                type=clip.type(), in_motion=clip.in_motion)
        return cls([seq_item])


class SequenceItemsMover:
    """Mover for any group of sequence items (commands.py:69-132):
    either all in one sequence, or homeless and pre-ordered."""

    def __init__(self, items):
        if items[0].sequence:
            items = sorted(items, key=lambda a: a.index)
            base_x = items[0].x
            self.overlap_movers = [
                SequenceOverlapItemsMover(group, group[0].x - base_x)
                for group in _split_sequence_items_by_overlap(items)]
        else:
            x = 0
            for index, item in enumerate(items):
                if index != 0:
                    x -= item.transition_length
                item._x = x
                item._index = index
                x += item.length
            self.overlap_movers = [
                SequenceOverlapItemsMover(group, group[0].x)
                for group in _split_sequence_items_by_overlap(items)]

    def to_item(self, height=10.0, x=0, y=0):
        """A space Item holding clones of these items: a Clip for one
        item, a Sequence otherwise (commands.py:102-132)."""
        if (len(self.overlap_movers) == 1 and
                len(self.overlap_movers[0].items) == 1):
            item = self.overlap_movers[0].items[0]
            return Clip(x=x, y=y, length=item.length, height=height,
                        type=item.type(), source=item.source,
                        offset=item.offset, in_motion=item.in_motion,
                        anchor=item.anchor)

        seq_items = []
        last_x = 0
        for group in self.overlap_movers:
            items = group.clone_items()
            items[0].update(transition_length=-(group.offset - last_x))
            seq_items.extend(items)
            last_x = group.offset + group.length

        return Sequence(x=x, y=y, type=seq_items[0].type(), items=seq_items,
                        height=height,
                        in_motion=self.overlap_movers[0].items[0].in_motion)


class NoRoomError(Exception):
    def __init__(self, message='There is no room for the item.', *args,
                 **kw):
        Exception.__init__(self, message, *args, **kw)


class CompoundCommand(UndoCommand):
    """A compound of already-performed commands (commands.py:347-367)."""

    def __init__(self, text, commands, done=False, parent=None):
        UndoCommand.__init__(self, text, parent)
        self._commands = commands
        self._done = done

    def redo(self):
        if not self._done:
            for command in self._commands:
                command.redo()
            self._done = True

    def undo(self):
        if self._done:
            for command in reversed(self._commands):
                command.undo()
            self._done = False


class UpdateItemPropertiesCommand(UndoCommand):
    """Set properties on an item; merges manually (commands.py:370-398)."""

    def __init__(self, item, parent=None, **properties):
        UndoCommand.__init__(self, 'Update item properties', parent)
        self.item = item
        self.orig_values = {name: getattr(item, name) for name in properties}
        self.new_values = properties
        self.done = False

    def mergeWith(self, next):
        if not isinstance(next, UpdateItemPropertiesCommand):
            return False
        self.new_values.update(next.new_values)
        return True

    def redo(self):
        if not self.done:
            self.item.update(**self.new_values)
            self.done = True

    def undo(self):
        if self.done:
            self.item.update(**self.orig_values)
            self.done = False


# Alias matching the separate sequence-item spelling some callers expect
UpdateSequenceItemPropertiesCommand = UpdateItemPropertiesCommand


class MoveItemCommand(UndoCommand):
    def __init__(self, item, x, y, parent=None):
        UndoCommand.__init__(self, 'Move item', parent)
        self.item = item
        self.command = UpdateItemPropertiesCommand(item, x=x, y=y)

    def mergeWith(self, next):
        if not isinstance(next, MoveItemCommand):
            return False
        self.command.mergeWith(next.command)
        return True

    def redo(self):
        if self.item.space is None:
            raise RuntimeError(
                'Item must belong to a space to use MoveItemCommand.')
        self.command.redo()

    def undo(self):
        self.command.undo()


class AddOverlapItemsToSequenceCommand(UndoCommand):
    """Insert a SequenceOverlapItemsMover into a sequence at
    space-relative *x* (commands.py:183-345)."""

    def __init__(self, sequence, mover, x, parent=None):
        UndoCommand.__init__(self, 'Add overlapping items to sequence',
                             parent)
        self.sequence = sequence
        self.mover = mover
        self.x = x

        if self.sequence.type() != self.mover.items[0].type():
            raise NoRoomError(
                'The item type is incompatible with the sequence type.')
        if self.where_can_fit(x) is None:
            raise NoRoomError
        self.orig_transition_length = self.mover.items[0].transition_length

    def redo(self):
        index = self.where_can_fit(self.x)
        if index is None:
            raise NoRoomError
        self.index = index

        x = self.x - self.sequence.x
        self.orig_sequence_x = self.sequence.x

        at_index = self.sequence[index] if index < len(self.sequence) \
            else None
        at_start = at_index is not None and not at_index.previous_item()
        old_x = at_index.x if at_index else self.sequence.length
        self.orig_next_item = (index < len(self.sequence) and
                               self.sequence[index]) or None
        self.orig_next_item_trans_length = (
            self.orig_next_item and self.orig_next_item.transition_length)

        self.mover.items[0].update(transition_length=(
            0 if at_start else old_x - x +
            (at_index.transition_length if at_index else 0)))
        self.sequence[index:index] = self.mover.items

        if self.orig_next_item:
            self.orig_next_item.update(
                transition_length=self.mover.length - (old_x - x))
        if at_start:
            self.sequence.update(x=self.sequence.x - (old_x - x))

    def undo(self):
        del self.sequence[self.index:self.index + len(self.mover.items)]
        if self.sequence.x != self.orig_sequence_x:
            self.sequence.update(x=self.orig_sequence_x)
        self.mover.items[0].update(
            transition_length=self.orig_transition_length)
        if self.orig_next_item:
            self.orig_next_item.update(
                transition_length=self.orig_next_item_trans_length)
        del self.index
        del self.orig_next_item
        del self.orig_next_item_trans_length

    def determine_range(self, index):
        """(min, max, index) placement range at *index*, in scene
        coordinates, or None (commands.py:269-331)."""
        if index < 0 or index > len(self.sequence):
            raise IndexError('index out of range')

        if index < len(self.sequence):
            seq_item = self.sequence[index]
            if seq_item.transition_length > 0 and seq_item.index > 0:
                return None

            prev_item = seq_item.previous_item()
            prev_prev_item = prev_item and prev_item.previous_item()
            next_item = seq_item.next_item()

            _min = max(
                (prev_item.x + (max(0, prev_item.transition_length)
                                if prev_prev_item else 0))
                if prev_item else -self.mover.length,
                seq_item.x + min(0, seq_item.transition_length) -
                (self.mover.max_fadein_length if prev_item
                 else self.mover.length))
            _max = (seq_item.x - self.mover.length +
                    min(self.mover.max_fadeout_length,
                        seq_item.length - (next_item.transition_length
                                           if next_item else 0)))

            _min += self.sequence.x
            _max += self.sequence.x

            if not prev_item:
                _min = None
            elif _max < _min:
                return None
            return _Placement(_min, _max, index)

        if not len(self.sequence):
            # empty sequence: anything fits at index 0 anywhere
            return _Placement(None, None, 0)
        prev_item = self.sequence[-1]
        prev_prev_item = prev_item and prev_item.previous_item()
        _min = max(
            prev_item.x + (max(0, prev_item.transition_length)
                           if prev_prev_item else 0),
            prev_item.x + prev_item.length - self.mover.max_fadein_length)
        _min += self.sequence.x
        return _Placement(_min, None, index)

    def where_can_fit(self, x):
        for _range in (self.determine_range(i)
                       for i in range(len(self.sequence) + 1)):
            if not _range:
                continue
            if ((_range.min is None or x >= _range.min) and
                    (_range.max is None or x <= _range.max)):
                return _range.index
        return None


class AddSequenceToSequenceCommand(UndoCommand):
    def __init__(self, sequence, mover, x, parent=None):
        """Add a SequenceItemsMover's groups to *sequence* at
        scene-relative *x* (commands.py:425-434)."""
        UndoCommand.__init__(self, 'Add sequence to sequence', parent)
        for group in mover.overlap_movers:
            AddOverlapItemsToSequenceCommand(sequence, group,
                                             x + group.offset, parent=self)


class MoveSequenceOverlapItemsInPlaceCommand(UndoCommand):
    """Slide an overlap group within its sequence without changing
    indexes (commands.py:436-530)."""

    def __init__(self, mover, offset, parent=None):
        UndoCommand.__init__(self,
                             'Move overlapping sequence items in place',
                             parent)
        self.mover = mover
        self.offset = offset
        self.sequence = self.mover.items[0].sequence
        if not self.sequence:
            raise ValueError('The given items are not in a sequence.')

    def id(self):
        return id(MoveSequenceOverlapItemsInPlaceCommand)

    def mergeWith(self, command):
        if not isinstance(command, MoveSequenceOverlapItemsInPlaceCommand):
            return False
        if self.mover is not command.mover:
            return False
        self.offset += command.offset

    def check_room(self):
        next_item = self.mover.items[-1].next_item()
        previous_item = self.mover.items[0].previous_item()

        if self.offset > 0 and next_item:
            next_next_item = next_item.next_item()
            max_offset = min(
                next_item.length -
                max(next_next_item.transition_length if next_next_item
                    else 0, 0) - next_item.transition_length,
                self.mover.max_fadeout_length - next_item.transition_length)
            if self.offset > max_offset:
                raise NoRoomError

        if self.offset < 0 and previous_item:
            min_offset = -min(
                previous_item.length -
                self.mover.items[0].transition_length -
                max(previous_item.transition_length, 0),
                self.mover.max_fadein_length -
                self.mover.items[0].transition_length)
            if self.offset < min_offset:
                raise NoRoomError

    def redo(self):
        self.check_room()
        next_item = self.mover.items[-1].next_item()
        if next_item:
            next_item.update(transition_length=next_item.transition_length +
                             self.offset)
        if self.mover.items[0].index == 0:
            self.sequence.update(x=self.sequence.x + self.offset)
        else:
            self.mover.items[0].update(
                transition_length=self.mover.items[0].transition_length -
                self.offset)

    def undo(self):
        next_item = self.mover.items[-1].next_item()
        if next_item:
            next_item.update(transition_length=next_item.transition_length -
                             self.offset)
        if self.mover.items[0].index == 0:
            self.sequence.update(x=self.sequence.x - self.offset)
        else:
            self.mover.items[0].update(
                transition_length=self.mover.items[0].transition_length +
                self.offset)


class MoveSequenceItemsInPlaceCommand(UndoCommand):
    """Slide a whole SequenceItemsMover in place; composed of per-group
    moves executed in a safe order (commands.py:532-611)."""

    def __init__(self, mover, offset, parent=None):
        UndoCommand.__init__(self, 'Move sequence items in place', parent)
        self.mover = mover
        self.offset = offset
        self.sequence = self.mover.overlap_movers[0].items[0].sequence
        if not self.sequence:
            raise ValueError('The given items are not in a sequence.')

        groups = mover.overlap_movers if offset < 0 \
            else list(reversed(mover.overlap_movers))
        self.commands = [
            MoveSequenceOverlapItemsInPlaceCommand(group, offset)
            for group in groups]

    def id(self):
        return id(MoveSequenceItemsInPlaceCommand)

    def mergeWith(self, command):
        if not isinstance(command, MoveSequenceItemsInPlaceCommand):
            return False
        if self.mover is not command.mover:
            return False
        if (self.offset < 0) != (command.offset < 0):
            for c1, c2 in zip(reversed(self.commands), command.commands):
                c1.mergeWith(c2)
        else:
            for c1, c2 in zip(self.commands, command.commands):
                c1.mergeWith(c2)
        if (self.offset < 0) != (self.offset + command.offset < 0):
            self.commands.reverse()
        self.offset += command.offset

    def check_room(self):
        self.redo()
        self.undo()

    def redo(self):
        done = -1
        try:
            for i, command in enumerate(self.commands):
                command.redo()
                done = i
        except Exception:
            for i in range(done, -1, -1):
                self.commands[i].undo()
            raise

    def undo(self):
        for command in reversed(self.commands):
            command.undo()


class RemoveAdjacentItemsFromSequenceCommand(UndoCommand):
    """Remove adjacent items while preserving sequence timing
    (commands.py:613-675)."""

    def __init__(self, items, parent=None):
        UndoCommand.__init__(self, 'Delete adjacent item(s) from sequence',
                             parent)
        for i in range(len(items) - 1):
            if items[i].index != items[i + 1].index - 1:
                raise ValueError(
                    'This operation is only supported on adjacent items.')

        self.items = items
        self.original_sequence = items[0].sequence
        self.original_x = items[0].x + self.original_sequence.x
        self.length = items[-1].x + items[-1].length - items[0].x
        self.original_sequence_index = items[0].index
        self.original_next = items[-1].next_item()
        self.original_next_trans_length = (
            self.original_next and self.original_next.transition_length)
        self.orig_trans_length = items[0].transition_length

    def redo(self):
        start = self.original_sequence_index
        del self.original_sequence[start:start + len(self.items)]

        if start == 0:
            self.original_sequence.update(
                x=self.original_sequence.x + self.length -
                (self.original_next.transition_length
                 if self.original_next else 0))
        if self.original_next:
            self.original_next.update(transition_length=(
                0 if start == 0 else
                (self.original_next_trans_length - self.length +
                 self.orig_trans_length)))

    def undo(self):
        start = self.original_sequence_index
        self.original_sequence[start:start] = self.items
        self.items[0].update(transition_length=self.orig_trans_length)
        if start == 0:
            self.original_sequence.update(x=self.original_x)
        if self.original_next:
            self.original_next.update(
                transition_length=self.original_next_trans_length)


class RemoveItemCommand(UndoCommand):
    """Remove an item from any mutable list (incl. spaces)
    (commands.py:677-695)."""

    def __init__(self, list_, item, parent=None):
        UndoCommand.__init__(self, 'Delete item', parent)
        self.list = list_
        self.item = item

    def redo(self):
        self.index = self.list.index(self.item)
        del self.list[self.index]

    def undo(self):
        self.list.insert(self.index, self.item)


class InsertItemCommand(UndoCommand):
    """Insert an item into a list (incl. spaces) (commands.py:697-715)."""

    def __init__(self, list_, item, index, parent=None):
        UndoCommand.__init__(self, 'Insert item', parent)
        self.list = list_
        self.item = item
        self.index = index

    def redo(self):
        self.list.insert(self.index, self.item)

    def undo(self):
        del self.list[self.index]


# Sequence-flavored aliases for the list commands
InsertSequenceItemCommand = InsertItemCommand
RemoveSequenceItemCommand = RemoveItemCommand


class AddClipCommand(InsertItemCommand):
    """Add a clip to a space at the top of the stack."""

    def __init__(self, space, clip, parent=None):
        InsertItemCommand.__init__(self, space, clip, len(space), parent)


class RemoveItemsFromSequenceCommand(UndoCommand):
    """Remove any set of items from one sequence; removes the whole
    sequence if everything is named (commands.py:717-732)."""

    def __init__(self, items, parent=None):
        UndoCommand.__init__(self, 'Delete item(s) from sequence', parent)
        if len(items) == len(items[0].sequence):
            RemoveItemCommand(items[0].sequence.space, items[0].sequence,
                              self)
        else:
            items = sorted(items, key=lambda a: a.index)
            # Remove groups in DESCENDING index order: children cache
            # original_sequence_index at construction, and removing an
            # earlier group first shifts later groups' indexes — the
            # reference's ascending order silently skipped later groups
            # and duplicated items on undo.
            for group in reversed(
                    _split_sequence_items_by_adjacency(items)):
                RemoveAdjacentItemsFromSequenceCommand(group, parent=self)


class _AdjustClipHandleCommand(UndoCommand):
    def __init__(self, text, item, offset, command, parent=None):
        UndoCommand.__init__(self, text, parent)
        self.item = item
        self.offset = offset
        self.command = command

    def id(self):
        return id(self.__class__)

    def mergeWith(self, next):
        if not isinstance(next, self.__class__) or self.item != next.item:
            return False
        self.command.mergeWith(next.command)
        self.offset += next.offset
        return True

    def redo(self):
        if self.item.space is None:
            raise RuntimeError('Item must belong to a space to use ' +
                               str(self.__class__) + '.')
        self.command.redo()

    def undo(self):
        self.command.undo()


class AdjustClipLengthCommand(_AdjustClipHandleCommand):
    def __init__(self, item, offset):
        if item.length + offset <= 0:
            raise NoRoomError
        _AdjustClipHandleCommand.__init__(
            self, 'Adjust clip length', item, offset,
            UpdateItemPropertiesCommand(item, length=item.length + offset))


class AdjustClipStartCommand(_AdjustClipHandleCommand):
    def __init__(self, item, offset):
        if item.length - offset <= 0:
            raise NoRoomError
        _AdjustClipHandleCommand.__init__(
            self, 'Adjust clip start', item, offset,
            UpdateItemPropertiesCommand(
                item, x=item.x + offset, offset=item.offset + offset,
                length=item.length - offset))


class SlipBehindCommand(_AdjustClipHandleCommand):
    def __init__(self, item, offset):
        _AdjustClipHandleCommand.__init__(
            self, 'Slip behind clip', item, offset,
            UpdateItemPropertiesCommand(item, offset=item.offset + offset))


class AdjustClipTopCommand(_AdjustClipHandleCommand):
    def __init__(self, item, offset):
        if item.height - offset <= 0.0:
            raise NoRoomError
        _AdjustClipHandleCommand.__init__(
            self, 'Adjust clip top', item, offset,
            UpdateItemPropertiesCommand(
                item, y=item.y + offset, height=item.height - offset))


class AdjustClipHeightCommand(_AdjustClipHandleCommand):
    def __init__(self, item, offset):
        if item.height + offset <= 0.0:
            raise NoRoomError
        _AdjustClipHandleCommand.__init__(
            self, 'Adjust clip height', item, offset,
            UpdateItemPropertiesCommand(item, height=item.height + offset))


class AdjustSequenceItemStartCommand(UndoCommand):
    """Move a sequence item's start without moving its neighbors
    (commands.py:821-886)."""

    def __init__(self, item, offset):
        if not item.sequence:
            raise RuntimeError('Item needs to belong to a sequence.')

        prev_item = item.previous_item()
        next_item = item.next_item()

        if item.length - offset < 1:
            raise NoRoomError('Cannot set length to zero or less.')
        if prev_item:
            prev_room = (prev_item.length -
                         max(prev_item.transition_length, 0) -
                         max(item.transition_length - offset, 0))
            if prev_room < 0:
                raise NoRoomError
        if next_item:
            if item.length - offset < next_item.transition_length:
                raise NoRoomError(
                    'Cannot move point past start of next item.')

        UndoCommand.__init__(self, 'Adjust sequence clip start')
        self.item = item
        self.offset = offset
        self.item_command = UpdateItemPropertiesCommand(
            item,
            transition_length=(item.transition_length - offset
                               if prev_item else 0),
            offset=item.offset + offset,
            length=item.length - offset)
        self.seq_command = (not prev_item and UpdateItemPropertiesCommand(
            item.sequence, x=item.sequence.x + offset))

    def id(self):
        return id(self.__class__)

    def mergeWith(self, next):
        if not isinstance(next, self.__class__) or self.item != next.item:
            return False
        self.item_command.mergeWith(next.item_command)
        self.offset += next.offset
        if self.seq_command:
            self.seq_command.mergeWith(next.seq_command)
        return True

    def redo(self):
        self.item_command.redo()
        if self.seq_command:
            self.seq_command.redo()

    def undo(self):
        if self.seq_command:
            self.seq_command.undo()
        self.item_command.undo()


class AdjustSequenceItemLengthCommand(UndoCommand):
    """Adjust a sequence item's length without moving its neighbors
    (commands.py:888-946)."""

    def __init__(self, item, offset):
        if not item.sequence:
            raise RuntimeError('Item needs to belong to a sequence.')

        next_item = item.next_item()
        next_next_item = next_item and next_item.next_item()

        if item.length + offset < 1:
            raise NoRoomError('Cannot set length to zero or less.')
        if next_item:
            next_room = (next_item.length -
                         (next_item.transition_length + offset) -
                         max(next_next_item.transition_length
                             if next_next_item else 0, 0))
            if next_room < 0:
                raise NoRoomError

        UndoCommand.__init__(self, 'Adjust sequence clip length')
        self.item = item
        self.offset = offset
        self.item_command = UpdateItemPropertiesCommand(
            item, length=item.length + offset)
        self.next_command = next_item and UpdateItemPropertiesCommand(
            next_item,
            transition_length=next_item.transition_length + offset)

    def id(self):
        return id(self.__class__)

    def mergeWith(self, next):
        if not isinstance(next, self.__class__) or self.item != next.item:
            return False
        self.item_command.mergeWith(next.item_command)
        self.offset += next.offset
        if self.next_command:
            self.next_command.mergeWith(next.next_command)
        return True

    def redo(self):
        self.item_command.redo()
        if self.next_command:
            self.next_command.redo()

    def undo(self):
        if self.next_command:
            self.next_command.undo()
        self.item_command.undo()


class BringItemForwardCommand(UndoCommand):
    def __init__(self, item):
        UndoCommand.__init__(self, 'Bring item forward')
        self.item = item
        self.remove_command = None
        self.insert_command = None

    def redo(self):
        item = self.item
        # Only same-lane items can be reordered by z: the composite
        # stacks by (y, z), so for a cross-lane overlap the lane wins
        # regardless of z — re-inserting would churn undo/dirty state
        # without changing a pixel (graph/video.py stacking note).
        overlaps = [x for x in item.overlap_items() if x.y == item.y]
        above_items = [x.z for x in overlaps if x.z < item.z]
        if not above_items:
            return
        bottom_z = max(above_items)
        self.remove_command = RemoveItemCommand(item.space, item)
        self.insert_command = InsertItemCommand(item.space, item, bottom_z)
        self.remove_command.redo()
        self.insert_command.redo()

    def undo(self):
        if self.insert_command:
            self.insert_command.undo()
            self.insert_command = None
            self.remove_command.undo()
            self.remove_command = None


class SendItemBackCommand(UndoCommand):
    def __init__(self, item):
        UndoCommand.__init__(self, 'Send item back')
        self.item = item
        self.remove_command = None
        self.insert_command = None

    def redo(self):
        item = self.item
        # Same-lane subset only; see BringItemForwardCommand.
        overlaps = [x for x in item.overlap_items() if x.y == item.y]
        below_items = [x.z for x in overlaps if x.z > item.z]
        if not below_items:
            return
        top_z = min(below_items)
        self.remove_command = RemoveItemCommand(item.space, item)
        self.insert_command = InsertItemCommand(item.space, item, top_z)
        self.remove_command.redo()
        self.insert_command.redo()

    def undo(self):
        if self.insert_command:
            self.insert_command.undo()
            self.insert_command = None
            self.remove_command.undo()
            self.remove_command = None
