"""Timeline items: anchors, clips, sequences.

Behavioral rebuild of the reference's fluggo/editor/model/items.py:
Anchor (:57-161), Item (:163-380), Clip (:383-412), PlaceholderItem,
Sequence + SequenceItem (:436-744) with the transition_length position
model, and the YAML tags (!CanvasItem, !CanvasClip, !CanvasSequence,
!CanvasSequenceItem, !CanvasAnchor), registered on the editor's own
YAML classes (``editor.yamlio``).
"""

from canvas_tpu_torch import ezlist, sortlist
from canvas_tpu_torch import process
from canvas_tpu_torch.editor import yamlio
from canvas_tpu_torch.signal import Signal

__all__ = ['Anchor', 'Item', 'Clip', 'PlaceholderItem', 'Sequence',
           'SequenceItem']


class Anchor:
    """Fixes one item's position relative to another (items.py:57-161).

    offset_ns is the time offset from the *target clip's* start to the
    anchored clip's start, in nanoseconds (frame rates may differ).
    two_way makes the anchor behave like a group.
    """

    yaml_tag = '!CanvasAnchor'

    def __init__(self, target=None, offset_ns=0, visible=False,
                 two_way=False):
        self._target = target
        self._offset_ns = int(offset_ns)
        self.y_offset = 0.0
        self._visible = bool(visible)
        self._two_way = bool(two_way)

    def _create_repr_dict(self):
        result = {'target': self._target}
        if self._offset_ns:
            result['offset_ns'] = self._offset_ns
        if self._visible:
            result['visible'] = self._visible
        if self._two_way:
            result['two_way'] = self._two_way
        return result

    @classmethod
    def to_yaml(cls, dumper, data):
        return dumper.represent_mapping(cls.yaml_tag,
                                        data._create_repr_dict())

    @classmethod
    def from_yaml(cls, loader, node):
        return cls(**loader.construct_mapping(node, deep=True))

    @classmethod
    def get_y_position(cls, item):
        if isinstance(item, SequenceItem):
            return item.sequence.y
        return item.y

    def get_y_offset(self, source):
        return (Anchor.get_y_position(source) -
                Anchor.get_y_position(self.target))

    def get_desired_x(self, source):
        """Desired absolute x for *source* in its own frame rate
        (items.py:123-135): target time + offset, rounded to the nearest
        source frame."""
        target_rate = self.target.space.rate(self.target.type())
        source_rate = source.space.rate(source.type())
        target_x = process.get_frame_time(target_rate,
                                          self.target.abs_x) + self._offset_ns
        # get_time_frame floors; add half a source frame to round
        target_x += process.get_frame_time(source_rate * 2, 1)
        return process.get_time_frame(source_rate, target_x)

    def get_desired_y(self):
        return Anchor.get_y_position(self.target) + self.y_offset

    def clone(self, target=None):
        result = self.__class__(**self._create_repr_dict())
        result.y_offset = self.y_offset
        if target:
            result._target = target
        return result

    target = property(lambda self: self._target)
    offset_ns = property(lambda self: self._offset_ns)
    visible = property(lambda self: self._visible)
    two_way = property(lambda self: self._two_way)


class Item:
    """Anything placeable on the canvas (items.py:163-380). x/length are
    integer frames (or samples); y/height are floats; z is maintained by
    the owning Space."""

    yaml_tag = '!CanvasItem'

    def __init__(self, x=0, y=0.0, length=1, height=1.0, type=None,
                 anchor=None, tags=None, ease_in=0, ease_out=0,
                 ease_in_type=None, ease_out_type=None, in_motion=False):
        self._space = None
        self._x = x
        self._y = y
        self._z = 0
        self._height = height
        self._length = length
        self._type = type
        self._ease_in_type = ease_in_type
        self._ease_in = ease_in
        self._ease_out_type = ease_out_type
        self._ease_out = ease_out
        self.updated = Signal()
        self._anchor = anchor
        self._tags = set(tags) if tags else set()
        self.in_motion = in_motion

    def clone(self):
        return self.__class__(**self._create_repr_dict())

    def _create_repr_dict(self):
        result = {'x': self._x, 'y': self._y, 'length': self._length,
                  'height': self._height, 'type': self._type}
        optional = (('anchor', self._anchor),
                    ('ease_in', self._ease_in),
                    ('ease_out', self._ease_out),
                    ('tags', list(self._tags) if self._tags else None))
        for key, value in optional:
            if value:
                result[key] = value
        if self._ease_in and self._ease_in_type:
            result['ease_in_type'] = self._ease_in_type
        if self._ease_out and self._ease_out_type:
            result['ease_out_type'] = self._ease_out_type
        return result

    @classmethod
    def to_yaml(cls, dumper, data):
        return dumper.represent_mapping(cls.yaml_tag,
                                        data._create_repr_dict())

    @classmethod
    def from_yaml(cls, loader, node):
        return cls(**loader.construct_mapping(node, deep=True))

    tags = property(lambda self: frozenset(self._tags))
    x = property(lambda self: self._x)
    abs_x = property(lambda self: self._x)
    anchor = property(lambda self: self._anchor)
    y = property(lambda self: self._y)
    z = property(lambda self: self._z)
    length = property(lambda self: self._length)
    height = property(lambda self: self._height)
    space = property(lambda self: self._space)

    @property
    def anchor_target(self):
        if self.anchor:
            return self.anchor.target
        if self.space:
            for item in self.space.find_immediate_anchored_items(self):
                if (item.anchor and item.anchor.target == self and
                        item.anchor.two_way):
                    return item
        return None

    def z_sort_key(self, y=None, z=None):
        """Composite-order sort key: smaller sorts on top of the stack.

        The reference returns a comparator object here
        (the reference's fluggo/editor/model/items.py:21-52, :279-280)
        that compares ``z`` only when the two items overlap and falls
        back to ``y`` otherwise — an INTRANSITIVE relation (A=B via z,
        B=C via y can leave A vs C inconsistent), so a live sorted
        structure keyed on it could drift from what a fresh sort of the
        same document produces. Its only consumer (the graph layer's
        watcher list, graph/video.py:93 in the reference) was replaced
        here by the deterministic total order ``(-y, -z)`` — lane on
        top, model z within lane, matching the reference's descending
        intent for every transitive case (see
        canvas_tpu_torch/editor/graph/video.py and docs/migration.md). This
        method stays for API parity and returns that same total order.
        """
        return (-(self._y if y is None else y),
                -(self._z if z is None else z))

    def overlaps(self, other):
        if (self.x >= other.x + other.length or
                self.x + self.length <= other.x):
            return False
        if (self.y >= other.y + other.height or
                self.y + self.height <= other.y):
            return False
        return True

    def _set_anchor(self, anchor):
        if self._anchor and self._space:
            self._space.remove_anchor_map(self, self._anchor.target)
            if self._anchor.two_way:
                self._space.remove_anchor_map(self._anchor.target, self)
        self._anchor = anchor
        if self._anchor and self._space:
            self._space.add_anchor_map(self, self._anchor.target)
            if self._anchor.two_way:
                self._space.add_anchor_map(self._anchor.target, self)

    _UPDATE_COERCE = {'x': ('_x', int), 'length': ('_length', int),
                      'y': ('_y', float), 'height': ('_height', float),
                      'z': ('_z', int)}

    def update(self, **kw):
        for key, (attr, coerce) in self._UPDATE_COERCE.items():
            if key in kw:
                setattr(self, attr, coerce(kw[key]))
        if 'in_motion' in kw:
            self.in_motion = bool(kw['in_motion'])
        if 'anchor' in kw:
            self._set_anchor(kw['anchor'])
        self.updated(**kw)

    def overlap_items(self):
        return self._space.find_overlaps_recursive(self)

    def kill(self):
        if self._anchor:
            self._space.remove_anchor_map(self, self._anchor.target)
            if self._anchor.two_way:
                self._space.remove_anchor_map(self._anchor.target, self)
        self._space = None

    def fixup(self):
        if self._anchor:
            self._space.add_anchor_map(self, self._anchor.target)
            if self._anchor.two_way:
                self._space.add_anchor_map(self._anchor.target, self)
            self._anchor.y_offset = self._anchor.get_y_offset(self)

    def type(self):
        return self._type

    def split(self, offset):
        raise NotImplementedError

    def can_join(self, other):
        return False

    def join(self, other):
        raise NotImplementedError


class Clip(Item):
    """A freestanding video or audio clip (items.py:383-412)."""

    yaml_tag = '!CanvasClip'

    def __init__(self, type=None, offset=0, source=None, **kw):
        Item.__init__(self, **kw)
        self._type = type
        self._source = source
        self._offset = offset

    def _create_repr_dict(self):
        result = Item._create_repr_dict(self)
        result['offset'] = self._offset
        if self._source:
            result['source'] = self._source
        return result

    def update(self, **kw):
        if 'offset' in kw:
            self._offset = int(kw['offset'])
        if 'source' in kw:
            self._source = kw['source']
        Item.update(self, **kw)

    source = property(lambda self: self._source)
    offset = property(lambda self: self._offset)


class PlaceholderItem(Item):
    """Stand-in with an item's geometry (items.py:414-424)."""

    def __init__(self, copy):
        Item.__init__(self, x=copy.x, y=copy.y, length=copy.length,
                      height=copy.height, type=copy.type())

    def _create_repr_dict(self):
        raise NotImplementedError


class Sequence(Item, ezlist.EZList):
    """A chain of back-to-back clips with transitions (items.py:426-571).

    Each SequenceItem's x is maintained relative to the sequence start:
    item.x = previous end - item.transition_length. The sequence's
    length tracks the whole chain.
    """

    yaml_tag = '!CanvasSequence'

    def __init__(self, type=None, items=None, expanded=False, **kw):
        Item.__init__(self, **kw)
        ezlist.EZList.__init__(self)
        self._type = type
        self._items = items if items is not None else []
        self._expanded = expanded
        self.item_added = Signal()
        self.items_removed = Signal()
        self.item_updated = Signal()
        if items:
            self.fixup()

    def _create_repr_dict(self):
        result = Item._create_repr_dict(self)
        result['type'] = self._type
        result['items'] = list(self._items)
        result['expanded'] = self._expanded
        del result['length']
        return result

    def type(self):
        return self._type

    expanded = property(lambda self: self._expanded)

    def update(self, **kw):
        # 'expanded' (the A/B-roll display flag) is updatable live; the
        # reference stores it but only sets it at construction
        # (items.py:444,471-472) — a live toggle is a strict extension,
        # and views listening on `updated` re-render on the flip
        if 'expanded' in kw:
            self._expanded = bool(kw['expanded'])
        Item.update(self, **kw)

    def __getitem__(self, index):
        return self._items[index]

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def _renumber_from(self, start):
        """Recompute x for items from *start* on; returns nothing. The
        first item's transition_length is included in the length."""
        x = 0
        if start > 0:
            prev = self._items[start - 1]
            x = prev._x + prev.length
        for item in self._items[start:]:
            item._sequence = self
            item._x = x - item.transition_length
            x += item.length - item.transition_length

    def _replace_range(self, start, stop, items):
        old_set = frozenset(self._items[start:stop])
        new_set = frozenset(items)

        for item in sorted(old_set - new_set, key=lambda a: -a.index):
            self._length -= item.length - item.transition_length
            if item.index == 0:
                self._length -= item.transition_length
            item.kill()

        if stop > start:
            self._items[start:stop] = []
            self._update_marks(start, stop, 0)
            self._renumber_from(start)
            self.items_removed(start, stop)

        self._items[start:start] = items
        self._update_marks(start, start, len(items))
        self._renumber_from(start)
        for item in self._items[start:]:
            item.fixup()

        # Emit in INDEX order: listeners (SequenceVideoManager) insert
        # watcher lists by item.index, so a frozenset-ordered emission
        # that delivers index N before its lower siblings exist crashes
        # a multi-item splice (paste / undo-restore) mid-signal.
        for item in sorted(new_set - old_set, key=lambda it: it.index):
            self._length += item.length - item.transition_length
            if item.index == 0:
                self._length += item.transition_length
            self.item_added(item)

        for item in self._items[start:]:
            self.item_updated(item, x=item._x)

        Item.update(self, length=self._length)

    def _move_items(self, start_index, xdiff, lendiff):
        if xdiff:
            item = self._items[start_index]
            item._x += xdiff
            self.item_updated(item, x=item._x)
        for item in self._items[start_index + 1:]:
            item._x += xdiff + lendiff
            self.item_updated(item, x=item._x)
        self.update(length=self.length + xdiff + lendiff)

    def fixup(self):
        Item.fixup(self)
        self._items = sortlist.AutoIndexList(self._items,
                                             index_attr='_index')
        total_length = (len(self) and self[0].transition_length) or 0
        for item in self._items:
            item._sequence = self
            item._type = self._type
            item._x = total_length - item.transition_length
            total_length += item.length - item.transition_length
            item.fixup()
        Item.update(self, length=total_length)


class SequenceItem:
    """One clip inside a Sequence (items.py:573-771)."""

    yaml_tag = '!CanvasSequenceItem'

    def __init__(self, source=None, offset=0, length=1, transition=None,
                 transition_length=0, type=None, in_motion=False,
                 anchor=None):
        if length < 1:
            raise ValueError(
                'length cannot be less than 1 ({0} was given)'.format(length))
        self._source = source
        self._offset = offset
        self._length = length
        self._transition = transition
        self._transition_length = transition_length
        self._sequence = None
        self._index = None
        self._type = type
        self._x = 0
        self._anchor = anchor
        self.in_motion = in_motion

    def clone(self):
        clone = self.__class__(**self._create_repr_dict())
        clone._type = self._type
        clone._x = self._x
        clone._index = self._index
        return clone

    def update(self, **kw):
        xdiff = 0
        lendiff = 0
        if 'source' in kw:
            self._source = kw['source']
        if 'offset' in kw:
            self._offset = int(kw['offset'])
        if 'length' in kw:
            new_length = int(kw['length'])
            if new_length < 1:
                raise ValueError(
                    'length cannot be less than 1 ({0} was given)'.format(
                        new_length))
            lendiff += new_length - self._length
            self._length = new_length
        if 'in_motion' in kw:
            self.in_motion = bool(kw['in_motion'])
        if 'anchor' in kw:
            space = self._sequence._space if self._sequence else None
            if self._anchor and space:
                space.remove_anchor_map(self, self._anchor.target)
                if self._anchor.two_way:
                    space.remove_anchor_map(self._anchor.target, self)
            self._anchor = kw['anchor']
            if self._anchor and space:
                space.add_anchor_map(self, self._anchor.target)
                if self._anchor.two_way:
                    space.add_anchor_map(self._anchor.target, self)
        if 'transition' in kw:
            self._transition = kw['transition']
        if 'transition_length' in kw:
            new_length = int(kw['transition_length'])
            xdiff -= new_length - self._transition_length
            self._transition_length = new_length

        if self._sequence:
            if xdiff or lendiff:
                self._sequence._move_items(self._index, xdiff, lendiff)
            self._sequence.item_updated(self, **kw)

    source = property(lambda self: self._source)
    offset = property(lambda self: self._offset)
    length = property(lambda self: self._length)
    transition = property(lambda self: self._transition)
    anchor = property(lambda self: self._anchor)
    index = property(lambda self: self._index)
    sequence = property(lambda self: self._sequence)
    x = property(lambda self: self._x)

    @property
    def transition_length(self):
        """Length of the transition preceding this clip: 0 = cut,
        positive = transition, negative = gap."""
        return self._transition_length

    @property
    def abs_x(self):
        return self._x + self._sequence.x

    def type(self):
        return self._type

    def previous_item(self, skip_in_motion=False):
        item = self
        while item.index > 0:
            item = item.sequence[item.index - 1]
            if skip_in_motion and item.in_motion:
                continue
            return item
        return None

    def next_item(self, skip_in_motion=False):
        item = self
        while item.index < len(item.sequence) - 1:
            item = item.sequence[item.index + 1]
            if skip_in_motion and item.in_motion:
                continue
            return item
        return None

    def _create_repr_dict(self):
        mapping = {'source': self._source, 'offset': self._offset,
                   'length': self._length}
        if self._transition_length:
            mapping['transition_length'] = self._transition_length
            if self._transition:
                mapping['transition'] = self._transition
        return mapping

    @classmethod
    def to_yaml(cls, dumper, data):
        return dumper.represent_mapping(cls.yaml_tag,
                                        data._create_repr_dict())

    @classmethod
    def from_yaml(cls, loader, node):
        return cls(**loader.construct_mapping(node, deep=True))

    def kill(self):
        if self._anchor and self._sequence._space:
            self._sequence._space.remove_anchor_map(self,
                                                    self._anchor.target)
            if self._anchor.two_way:
                self._sequence._space.remove_anchor_map(self._anchor.target,
                                                        self)
        self._sequence = None
        self._index = None

    def fixup(self):
        if self._anchor and self._sequence._space:
            self._sequence._space.add_anchor_map(self, self._anchor.target)
            if self._anchor.two_way:
                self._sequence._space.add_anchor_map(self._anchor.target,
                                                     self)
            self._anchor.y_offset = self._anchor.get_y_offset(self)

    def __str__(self):
        return yamlio.dump(self)


def _yamlreg(cls):
    yamlio.register(cls, cls.yaml_tag, cls.to_yaml, cls.from_yaml)


_yamlreg(Anchor)
_yamlreg(Item)
_yamlreg(Clip)
_yamlreg(Sequence)
_yamlreg(SequenceItem)
