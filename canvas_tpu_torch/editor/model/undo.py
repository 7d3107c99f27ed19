"""Toolkit-free undo framework.

Replaces Qt's QUndoCommand/QUndoStack (the reference's undo machinery,
commands.py + qttest.py) with the same semantics: command objects with
redo()/undo(), child commands executed by the parent's default
redo/undo, id()-based merging on push, and a stack with clean-state
tracking.
"""

from canvas_tpu_torch.signal import Signal

__all__ = ['UndoCommand', 'UndoStack']


class UndoCommand:
    """Base command. Children (created with ``parent=``) run inside the
    parent's default redo/undo, first-to-last / last-to-first."""

    def __init__(self, text='', parent=None):
        self._text = text
        self._children = []
        if parent is not None:
            parent._children.append(self)

    def text(self):
        return self._text

    def child_count(self):
        return len(self._children)

    def child(self, i):
        return self._children[i]

    def id(self):
        """Commands with the same non-negative id may merge on push."""
        return -1

    def mergeWith(self, command):
        return False

    def redo(self):
        for child in self._children:
            child.redo()

    def undo(self):
        for child in reversed(self._children):
            child.undo()


class UndoStack:
    """QUndoStack-alike: push() executes the command (redo) and merges it
    with the previous command when both report the same id()."""

    def __init__(self):
        self._commands = []
        self._index = 0          # number of done commands
        self._clean_index = 0
        self.index_changed = Signal()
        self.clean_changed = Signal()

    def push(self, command):
        was_clean = self.is_clean()
        # Drop the redo tail
        del self._commands[self._index:]
        if self._clean_index > self._index:
            self._clean_index = -1

        command.redo()

        # Merging is forbidden AT the clean index (QUndoStack): merging
        # into the saved-state command would make a dirty document
        # report clean and undo past the save point in one step.
        if (self._commands and self._index > 0
                and self._index != self._clean_index):
            prev = self._commands[self._index - 1]
            if (prev.id() != -1 and prev.id() == command.id() and
                    prev.mergeWith(command) is not False):
                self.index_changed(self._index)
                return

        self._commands.append(command)
        self._index += 1
        self.index_changed(self._index)
        if was_clean:
            self.clean_changed(False)

    def can_undo(self):
        return self._index > 0

    def can_redo(self):
        return self._index < len(self._commands)

    def undo(self):
        if not self.can_undo():
            return
        was_clean = self.is_clean()
        self._index -= 1
        self._commands[self._index].undo()
        self.index_changed(self._index)
        if self._index == self._clean_index:
            self.clean_changed(True)
        elif was_clean:
            self.clean_changed(False)

    def redo(self):
        if not self.can_redo():
            return
        was_clean = self.is_clean()
        self._commands[self._index].redo()
        self._index += 1
        self.index_changed(self._index)
        if self._index == self._clean_index:
            self.clean_changed(True)
        elif was_clean:
            self.clean_changed(False)

    def undo_text(self):
        return self._commands[self._index - 1].text() if self.can_undo() \
            else ''

    def redo_text(self):
        return self._commands[self._index].text() if self.can_redo() else ''

    @property
    def index(self):
        return self._index

    def count(self):
        return len(self._commands)

    def is_clean(self):
        return self._index == self._clean_index

    def set_clean(self):
        self._clean_index = self._index
        self.clean_changed(True)

    def clear(self):
        was_clean = self.is_clean()
        self._commands = []
        self._index = 0
        self._clean_index = 0
        if not was_clean:
            self.clean_changed(True)
