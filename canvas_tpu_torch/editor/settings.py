"""Editor settings store.

Replaces the reference's QSettings usage (plugin/codec enablement and
priorities, _base.py:268-284,370-384) with a JSON-backed key/value store.
Keys are flat strings ('plugins/<urn>/enabled'). Tests and embedders can
point the store at a temp file or use an in-memory store. The default
file is ``~/.config/canvas_tpu_torch/settings.json``, apart from the JAX
editor's (``~/.config/canvas_tpu/``): each editor keeps its own plugin
and codec choices.
"""

import json
import os
import threading

__all__ = ['Settings', 'get_settings', 'set_settings_path']

_lock = threading.Lock()
_instance = None
_path_override = None


class Settings:
    def __init__(self, path=None):
        self.path = path
        self._data = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except Exception:
                self._data = {}

    def get(self, key, default=None):
        return self._data.get(key, default)

    def set(self, key, value):
        self._data[key] = value
        self._save()

    def remove(self, key):
        self._data.pop(key, None)
        self._save()

    def _save(self):
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, 'w') as f:
            json.dump(self._data, f, indent=1, sort_keys=True)


def set_settings_path(path):
    """Point the global settings at *path* (None = in-memory only).
    Resets the store."""
    global _instance, _path_override
    with _lock:
        _path_override = path
        _instance = Settings(path)


def get_settings():
    global _instance
    with _lock:
        if _instance is None:
            default = os.path.join(
                os.path.expanduser('~'), '.config', 'canvas_tpu_torch',
                'settings.json')
            _instance = Settings(_path_override or default)
        return _instance
