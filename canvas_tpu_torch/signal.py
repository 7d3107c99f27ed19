"""Weakref-based signal/slot: the port's copy of ``canvas_tpu/signal.py``.

A source's ``frames_updated`` is such a signal; the planner
(``render.RenderPlanner``) and the playback engine connect to it.
Connecting a bound method does not keep its object alive; dead slots
are dropped silently. Plain functions are also supported (held
strongly).
"""

import weakref

__all__ = ['Signal']


class Signal:
    def __init__(self):
        # key -> weakref to the receiver object (None key part for functions)
        self._slots = {}

    def __call__(self, *args, **kwargs):
        for key in list(self._slots):
            entry = self._slots.get(key)
            if entry is None:
                continue
            func, ref = entry
            if ref is None:
                func(*args, **kwargs)
            else:
                obj = ref()
                if obj is None:
                    self._slots.pop(key, None)
                else:
                    func(obj, *args, **kwargs)

    fire = __call__

    @staticmethod
    def _method_parts(slot):
        """(func, obj) for a weakref-able bound method, else None.
        Builtin bound methods (list.append) have __self__ but no
        __func__, and __slots__ objects refuse weakrefs — both fall
        back to being held strongly like plain functions."""
        obj = getattr(slot, '__self__', None)
        func = getattr(slot, '__func__', None)
        if obj is None or func is None:
            return None
        try:
            weakref.ref(obj)
        except TypeError:
            return None
        return (func, obj)

    def connect(self, slot):
        parts = self._method_parts(slot)
        if parts is not None:
            func, obj = parts
            key = (func, id(obj))

            def _cleanup(ref, self_ref=weakref.ref(self), key=key):
                inst = self_ref()
                # Only pop the entry this dying ref created: the key is
                # (func, id(obj)), and a new object allocated at the
                # same id may have re-registered under it.
                if inst is not None:
                    entry = inst._slots.get(key)
                    if entry is not None and entry[1] is ref:
                        inst._slots.pop(key, None)

            self._slots[key] = (func, weakref.ref(obj, _cleanup))
        else:
            key = (slot, None)
            self._slots[key] = (slot, None)

    def disconnect(self, slot):
        parts = self._method_parts(slot)
        if parts is not None:
            key = (parts[0], id(parts[1]))
        else:
            key = (slot, None)
        self._slots.pop(key, None)

    def clear(self):
        self._slots.clear()

    def __len__(self):
        return len(self._slots)
