"""Auto-indexing and sorted list containers for the editor model.

Capability match for the reference's fluggo/sortlist.py:22-166:

* ``AutoIndexList`` — an EZList that writes each item's index onto the item
  (``index_attr``) so ``index()`` is O(1).
* ``SortedList`` — keeps items ordered by ``keyfunc``; ``move(i)`` re-sorts a
  single item whose key changed; ``find(min_key, max_key)`` returns a slice.
"""

import bisect
from collections.abc import Sequence

from canvas_tpu_torch import ezlist

__all__ = ['AutoIndexList', 'SortedList']


class AutoIndexList(ezlist.EZList):
    def __init__(self, iterable=None, index_attr=None):
        ezlist.EZList.__init__(self)
        self.index_attr = index_attr
        self.list = list(iterable) if iterable else []

        if index_attr:
            for i, item in enumerate(self.list):
                setattr(item, index_attr, i)

    def _replace_range(self, start, stop, items):
        if self.index_attr:
            for i, item in enumerate(items, start):
                setattr(item, self.index_attr, i)

        self.list[start:stop] = items

        if self.index_attr and stop - start != len(items):
            tail_start = start + len(items)
            for i, item in enumerate(self.list[tail_start:], tail_start):
                setattr(item, self.index_attr, i)

        self._update_marks(start, stop, len(items))

    def index(self, item):
        if self.index_attr:
            return getattr(item, self.index_attr)
        return self.list.index(item)

    def __getitem__(self, index):
        return self.list[index]

    def __len__(self):
        return len(self.list)


class SortedList(Sequence):
    def __init__(self, iterable=None, keyfunc=None, index_attr=None):
        self.keyfunc = keyfunc

        if iterable:
            items = sorted(iterable, key=keyfunc)
            self.list = AutoIndexList(items, index_attr=index_attr)
            if keyfunc:
                self.keys = [keyfunc(item) for item in items]
            else:
                self.keys = list(items)
        else:
            self.list = AutoIndexList(index_attr=index_attr)
            self.keys = []

    def add(self, item):
        key = self.keyfunc(item) if self.keyfunc else item
        index = bisect.bisect_left(self.keys, key)
        self.list.insert(index, item)
        self.keys.insert(index, key)

    def index(self, item):
        if self.list.index_attr:
            return self.list.index(item)

        key = self.keyfunc(item) if self.keyfunc else item
        index = bisect.bisect_left(self.keys, key)

        while True:
            if index >= len(self.list) or self.keys[index] != key:
                raise ValueError(item)
            if self.list[index] == item:
                return index
            index += 1

    def remove(self, item):
        del self[self.index(item)]

    def move(self, index):
        """Re-sort the item at *index* after its key changed."""
        item = self.list[index]
        del self[index]
        self.add(item)

    def find(self, min_key=None, max_key=None):
        min_index = 0
        max_index = len(self.list)
        if min_key is not None:
            min_index = bisect.bisect_left(self.keys, min_key)
        if max_key is not None:
            max_index = bisect.bisect_right(self.keys, max_key)
        return self.list[min_index:max_index]

    def __getitem__(self, index):
        return self.list[index]

    def __delitem__(self, index):
        del self.list[index]
        del self.keys[index]

    def __len__(self):
        return len(self.list)

    def __repr__(self):
        return '[' + ', '.join(repr(item) for item in self) + ']'
