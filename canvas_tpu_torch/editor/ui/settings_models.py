"""Headless view-models for the plugin and decoder settings dialogs.

Toolkit-free equivalents of the reference's Qt dialogs
(fluggo/editor/ui/plugineditor.py — a checkable plugin
list; codeceditor.py — a decoder table with enable checkboxes and
up/down priority reordering). The models expose exactly the operations
those dialogs perform against PluginManager; a Qt/any-toolkit paint
layer renders `rows()` and calls the mutators.
"""

from canvas_tpu_torch.editor.plugins import CodecPlugin, PluginManager
from canvas_tpu_torch.signal import Signal

__all__ = ['PluginEditorModel', 'DecoderEditorModel']


class PluginEditorModel:
    """Checkable list of discovered plugins (plugineditor.py:28-66)."""

    def __init__(self):
        PluginManager.load_all()
        self.changed = Signal()

    def rows(self):
        """[(plugin, name, description, enabled)] sorted by name."""
        plugins = PluginManager.find_plugins(enabled_only=False)
        out = []
        for plugin in sorted(plugins, key=lambda p: p.name):
            out.append((plugin, plugin.name, plugin.description,
                        PluginManager.is_plugin_enabled(plugin)))
        return out

    def set_enabled(self, plugin, enabled):
        PluginManager.set_plugin_enabled(plugin, bool(enabled))
        self.changed()


class DecoderEditorModel:
    """Decoder table with priority reordering (codeceditor.py:27-135).

    Rows list every decoder from every codec plugin, ordered the way
    `find_decoders` resolves them (priority descending); `move_up` /
    `move_down` adjust priorities exactly like the dialog's buttons.
    """

    def __init__(self):
        PluginManager.load_all()
        self.changed = Signal()

    def rows(self):
        """[(decoder, name, format_urns, enabled, priority)]."""
        decoders = []
        for plugin in PluginManager.find_plugins(CodecPlugin):
            decoders.extend(plugin.get_all_codecs())
        decoders.sort(key=lambda d: (-PluginManager.get_decoder_priority(d),
                                     d.name))
        return [(d, d.name, sorted(d.format_urns),
                 PluginManager.is_decoder_enabled(d),
                 PluginManager.get_decoder_priority(d))
                for d in decoders]

    def set_enabled(self, decoder, enabled):
        PluginManager.set_decoder_enabled(decoder, bool(enabled))
        self.changed()

    def move_up(self, decoder):
        self._bump(decoder, +1)

    def move_down(self, decoder):
        self._bump(decoder, -1)

    def _bump(self, decoder, direction):
        """Swap priority with the neighbor in the displayed order
        (codeceditor.py:125-134)."""
        rows = self.rows()
        idx = next(i for i, r in enumerate(rows) if r[0] is decoder)
        other_idx = idx - direction      # up = earlier row
        if other_idx < 0 or other_idx >= len(rows):
            return
        other = rows[other_idx][0]
        p_self = PluginManager.get_decoder_priority(decoder)
        p_other = PluginManager.get_decoder_priority(other)
        if p_self == p_other:
            PluginManager.set_decoder_priority(decoder,
                                               p_self + direction)
        else:
            PluginManager.set_decoder_priority(decoder, p_other)
            PluginManager.set_decoder_priority(other, p_self)
        self.changed()
