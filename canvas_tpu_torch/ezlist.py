"""EZList: a MutableSequence built on a single _replace_range primitive,
with gravity-aware position marks.

Capability match for the reference's fluggo/ezlist.py:21-156. Subclasses
implement ``_replace_range(start, stop, items)`` and call ``_update_marks``;
every list mutation funnels through it, so observers only need one hook.
Marks are weakly held positions that slide with edits: a left-gravity mark
sticks to the start of a replaced range, a right-gravity mark to its end.
"""

import functools
import weakref
from collections.abc import MutableSequence

__all__ = ['EZList']


class EZList(MutableSequence):
    def __init__(self):
        self._marks = []

    @functools.total_ordering
    class Mark:
        __slots__ = ('index', 'left_gravity', '__weakref__')

        def __init__(self, index, left_gravity):
            self.index = index
            self.left_gravity = left_gravity

        # Marks act like plain ints in arithmetic and comparisons
        __index__ = __int__ = lambda self: self.index
        __add__ = lambda self, o: self.index + o.__index__()
        __radd__ = lambda self, o: o.__index__() + self.index
        __sub__ = lambda self, o: self.index - o.__index__()
        __rsub__ = lambda self, o: o.__index__() - self.index
        __lt__ = lambda self, o: self.index < o.__index__()
        __eq__ = lambda self, o: self.index == o.__index__()
        __hash__ = lambda self: id(self)

        def __repr__(self):
            return 'Mark({0.index}, left_gravity={0.left_gravity})'.format(
                self)

    def _replace_range(self, start, stop, items):
        """Replace range(start, stop) with *items* (any length).

        Subclasses must mutate their storage and then call
        ``self._update_marks(start, stop, len(items))``.
        """
        raise NotImplementedError

    def _iter_marks(self):
        i = 0
        while i < len(self._marks):
            mark = self._marks[i]()
            if mark is None:
                del self._marks[i]
            else:
                i += 1
                yield mark

    def create_mark(self, index, left_gravity):
        if index < 0 or index > len(self):
            raise IndexError(index)

        for mark in self._iter_marks():
            if mark.index == index and mark.left_gravity == left_gravity:
                return mark

        mark = self.Mark(index, left_gravity)
        self._marks.append(weakref.ref(mark))
        return mark

    def _update_marks(self, start, stop, new_length):
        for mark in self._iter_marks():
            if mark.index < start:
                continue
            if mark.index <= stop:
                mark.index = start if mark.left_gravity else start + new_length
            else:
                mark.index += new_length - (stop - start)

    def insert(self, index, value):
        self[index:index] = [value]

    def _check_index(self, key):
        """Normalize an integer index with list semantics: negative
        wraps once, out-of-range raises (the slice fallback used to
        silently append/prepend on a bad index and stamp wrong
        positions into the marks)."""
        key = key.__index__()
        n = len(self)
        if key < 0:
            key += n
        if key < 0 or key >= n:
            raise IndexError('EZList index out of range')
        return key

    def __setitem__(self, key, value):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            items = list(value)
            if step == 1:
                self._replace_range(start, stop, items)
                return
            indices = range(start, stop, step)
            if len(items) != len(indices):
                # list semantics; the old pad-with-deletes loop shifted
                # later indices mid-iteration and corrupted the list
                raise ValueError(
                    'attempt to assign sequence of size %d to extended '
                    'slice of size %d' % (len(items), len(indices)))
            # 1:1 replacement never shifts later indices
            for j, item in zip(indices, items):
                self._replace_range(j, j + 1, [item])
            return
        key = self._check_index(key)
        self._replace_range(key, key + 1, [value])

    def __delitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step == 1:
                self._replace_range(start, stop, [])
                return
            # descending order so earlier removals can't shift the
            # indices still to be removed
            for j in sorted(range(start, stop, step), reverse=True):
                self._replace_range(j, j + 1, [])
            return
        key = self._check_index(key)
        self._replace_range(key, key + 1, [])
