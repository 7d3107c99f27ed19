"""Plugin framework: alerts, plugin base/manager, manifests.

Headless rebuild of the reference's fluggo/editor/plugins/_base.py:
  * Alert / AlertIcon / AlertPublisher with weakref alert-following
    (_base.py:29-179)
  * Plugin base class (_base.py:192-219)
  * PluginManager: scans ``*.plugin`` INI manifests on its search paths,
    imports modules, activates enabled plugins, maintains codec priority
    ordering (_base.py:224-449) — enablement/priorities live in the JSON
    settings store instead of QSettings.
"""

import configparser
import importlib
import importlib.util
import os
import sys
import traceback
import weakref

from canvas_tpu_torch import logging as _logging
from canvas_tpu_torch.signal import Signal
from canvas_tpu_torch.editor.settings import get_settings

_log = _logging.getLogger(__name__)

__all__ = ['Alert', 'AlertIcon', 'AlertPublisher', 'Plugin', 'PluginManager',
           'PluginModule']


class _AlertTracker:
    """Weakref-following glue between two publishers (_base.py:29-68)."""

    def __init__(self, trackee, tracker):
        self.trackee = weakref.ref(trackee, self.stop_tracking)
        self.tracker = tracker
        self.alerts = None
        trackee.alert_added.connect(self.item_added)
        trackee.alert_removed.connect(self.item_removed)
        for alert in list(trackee._alerts.values()):
            self.item_added(alert)

    def stop_tracking(self, weakref_=None):
        if hasattr(self, 'trackee'):
            trackee = self.trackee()
            if trackee is not None:
                trackee.alert_added.disconnect(self.item_added)
                trackee.alert_removed.disconnect(self.item_removed)
        if getattr(self, 'alerts', None) is not None:
            for alert in self.alerts.values():
                self.tracker.hide_alert(alert)
            self.alerts = None

    def item_added(self, alert):
        if self.alerts is None:
            self.alerts = {}
        self.alerts[alert.key] = alert
        self.tracker.show_alert(alert)

    def item_removed(self, alert):
        if self.alerts and alert.key in self.alerts:
            del self.alerts[alert.key]
        self.tracker.hide_alert(alert)


class AlertPublisher:
    """Mixin that reports errors and lets the user manage them
    (_base.py:70-111)."""

    def __init__(self):
        self.alert_added = Signal()
        self.alert_removed = Signal()
        self._alerts = {}
        self._tracked_publishers = None

    def show_alert(self, alert):
        self.hide_alert(alert)
        self._alerts[alert.key] = alert
        self.alert_added(alert)

    def hide_alert(self, alert):
        if alert.key in self._alerts:
            del self._alerts[alert.key]
            self.alert_removed(alert)

    @property
    def alerts(self):
        return list(self._alerts.values())

    def follow_alerts(self, publisher):
        if publisher is None:
            # source-less items (placeholders) have no stream to track;
            # weakref.ref(None) would raise
            return
        if self._tracked_publishers is None:
            self._tracked_publishers = weakref.WeakKeyDictionary()
        if publisher not in self._tracked_publishers:
            self._tracked_publishers[publisher] = _AlertTracker(publisher,
                                                                self)

    def unfollow_alerts(self, publisher):
        if publisher is None or self._tracked_publishers is None:
            return
        tracker = self._tracked_publishers.pop(publisher, None)
        if tracker is not None:
            tracker.stop_tracking()


class AlertIcon:
    NoIcon, Information, Warning, Error = range(4)


class Alert:
    """A user-facing alert (_base.py:116-189)."""

    def __init__(self, description, icon=AlertIcon.NoIcon, source='',
                 model_obj=None, actions=(), exc_info=False, key=None):
        self.key = key if key is not None else self
        self._description = description
        self._source = source
        self._icon = icon
        self._actions = list(actions)
        self._model_obj = model_obj
        self._exc_info = sys.exc_info() if exc_info else None

    @property
    def description(self):
        return self._description

    @property
    def source(self):
        return self._source

    @property
    def icon(self):
        return self._icon

    @property
    def actions(self):
        return self._actions

    @property
    def model_object(self):
        return self._model_obj

    @property
    def exc_info(self):
        return self._exc_info

    def __str__(self):
        result = str(self._description)
        if self._source:
            result = self._source + ': ' + result
        if self._exc_info:
            result += '\r\n' + ''.join(
                traceback.format_exception(*self._exc_info))
        return result


class Plugin:
    """Base plugin (_base.py:192-219)."""

    #: Optional class-level AlertPublisher for this plugin.
    alerts = None
    name = None
    description = None
    plugin_urn = None
    #: URNs this plugin also answers to. Lets projects saved by other
    #: builds (notably the reference's
    #: 'urn:fluggo.com/canvas/plugins:libav-dv', dv.py:36) resolve their
    #: plugin sources here. Aliases never claim a registry slot — a
    #: plugin whose primary urn matches always wins.
    plugin_urn_aliases = ()

    @classmethod
    def activate(cls):
        pass

    @classmethod
    def deactivate(cls):
        pass


PLUGINS_PREFIX = 'plugins/'
DECODERS_PREFIX = 'decoders/'


class PluginModule:
    """One ``*.plugin`` manifest: [Plugin] name=..., module=...
    (_base.py:451-480)."""

    def __init__(self, name, module_name):
        self.name = name
        self.module_name = module_name
        self.module = None

    @classmethod
    def from_file(cls, path):
        parser = configparser.ConfigParser()
        parser.read(path)
        return cls(parser.get('Plugin', 'name'),
                   parser.get('Plugin', 'module'))

    def load(self):
        if self.module is not None:
            return
        try:
            self.module = importlib.import_module(self.module_name)
        except Exception:
            _log.warning('Could not load plugin module {0}',
                         self.module_name, exc_info=True)
            self.module = None


class PluginManager:
    plugin_modules = None
    plugins = None
    enabled_plugins = None
    codecs = []
    codecs_by_priority = []
    alert_manager = AlertPublisher()
    #: Extra manifest search paths (beyond the built-in plugins package).
    search_paths = []

    @classmethod
    def load_all(cls):
        if cls.plugin_modules is not None:
            return
        paths = [os.path.dirname(__file__)] + list(cls.search_paths)
        cls.plugin_modules = list(cls.find_all_modules(paths))
        plugin_classes = []

        for module in cls.plugin_modules:
            module.load()
            if not module.module:
                continue
            plugin_classes.extend(
                plugin for (name, plugin) in module.module.__dict__.items()
                if not name.startswith('_') and isinstance(plugin, type) and
                issubclass(plugin, Plugin) and plugin not in (Plugin,))

        plugins = {}
        for plugin_cls in plugin_classes:
            if not plugin_cls.plugin_urn:
                continue
            existing = plugins.setdefault(plugin_cls.plugin_urn, plugin_cls)
            if plugin_cls is not existing:
                _log.error('Two plugins claim the URN "{0}"',
                           plugin_cls.plugin_urn)

        cls.plugins = plugins
        cls.enabled_plugins = {}

        settings = get_settings()
        for key, plugin in cls.plugins.items():
            if settings.get(PLUGINS_PREFIX + key + '/enabled', False):
                cls._activate(key, plugin)
        cls.reset_codecs()

    @classmethod
    def _activate(cls, key, plugin):
        try:
            plugin.activate()
            if plugin.alerts:
                cls.alert_manager.follow_alerts(plugin.alerts)
            cls.enabled_plugins[key] = plugin
        except Exception:
            _log.error('Failed to activate plugin "{0}"', plugin.name,
                       exc_info=True)

    @classmethod
    def find_all_modules(cls, paths):
        for path in paths:
            if not os.path.isdir(path):
                continue
            for dirpath, _dirs, files in os.walk(path):
                for name in files:
                    if name.endswith('.plugin'):
                        try:
                            yield PluginModule.from_file(
                                os.path.join(dirpath, name))
                        except Exception:
                            _log.warning('Bad plugin manifest {0}', name,
                                         exc_info=True)

    @classmethod
    def find_plugins(cls, baseclass=Plugin, enabled_only=True):
        cls.load_all()
        source = cls.enabled_plugins if enabled_only else cls.plugins
        return [p for p in source.values() if issubclass(p, baseclass)]

    @classmethod
    def find_plugin_by_urn(cls, urn, enabled_only=True):
        cls.load_all()
        source = cls.enabled_plugins if enabled_only else cls.plugins
        plugin = source.get(urn)
        if plugin is not None:
            return plugin
        for plugin in source.values():
            if urn in plugin.plugin_urn_aliases:
                return plugin
        return None

    @classmethod
    def is_plugin_enabled(cls, plugin):
        cls.load_all()
        return plugin.plugin_urn in cls.enabled_plugins

    @classmethod
    def enable_all_for_session(cls):
        """Activate every discovered plugin IN MEMORY ONLY — no settings
        write. For headless one-shot tools (scripts/explain.py, batch
        exports) that need media refs to resolve without mutating the
        user's persisted plugin choices."""
        cls.load_all()
        for key, plugin in cls.plugins.items():
            if key not in cls.enabled_plugins:
                cls._activate(key, plugin)
        cls.reset_codecs()

    @classmethod
    def set_plugin_enabled(cls, plugin, enable):
        cls.load_all()
        settings = get_settings()
        settings.set(PLUGINS_PREFIX + plugin.plugin_urn + '/enabled',
                     bool(enable))
        if enable and plugin.plugin_urn not in cls.enabled_plugins:
            cls._activate(plugin.plugin_urn, plugin)
        elif not enable and plugin.plugin_urn in cls.enabled_plugins:
            try:
                plugin.deactivate()
            except Exception:
                _log.error('Failed to deactivate plugin "{0}"', plugin.name,
                           exc_info=True)
            del cls.enabled_plugins[plugin.plugin_urn]
        cls.reset_codecs()

    # -- codecs (_base.py:358-449) ----------------------------------------

    @classmethod
    def reset_codecs(cls):
        from canvas_tpu_torch.editor.plugins._codec import CodecPlugin
        cls.codecs = []
        for plugin in cls.find_plugins(CodecPlugin):
            try:
                cls.codecs.extend(plugin.get_all_codecs())
            except Exception:
                _log.error('Failed to get codecs from "{0}"', plugin.name,
                           exc_info=True)
        settings = get_settings()

        def priority(codec):
            return settings.get(DECODERS_PREFIX + codec.urn + '/priority',
                                codec.default_priority)

        enabled = [c for c in cls.codecs if cls.is_decoder_enabled(c)]
        # Stable sort: higher priority first
        cls.codecs_by_priority = sorted(enabled, key=priority, reverse=True)

    @classmethod
    def get_all_codecs(cls):
        cls.load_all()
        return list(cls.codecs)

    @classmethod
    def find_codec_by_urn(cls, urn):
        cls.load_all()
        for codec in cls.codecs:
            if codec.urn == urn:
                return codec
        for codec in cls.codecs:
            if urn in codec.urn_aliases:
                return codec
        return None

    get_codec_by_urn = find_codec_by_urn

    @classmethod
    def find_decoders(cls, format_urn=None, enabled_only=True):
        cls.load_all()
        codecs = cls.codecs_by_priority if enabled_only else cls.codecs
        return [c for c in codecs if c.can_decode and
                (format_urn is None or format_urn in c.format_urns or
                 getattr(c, 'accepts_all_formats', False))]

    @classmethod
    def is_decoder_enabled(cls, codec=None, codec_urn=None):
        urn = codec_urn or codec.urn
        return get_settings().get(DECODERS_PREFIX + urn + '/enabled', True)

    @classmethod
    def set_decoder_enabled(cls, codec, enable):
        get_settings().set(DECODERS_PREFIX + codec.urn + '/enabled',
                           bool(enable))
        cls.reset_codecs()

    @classmethod
    def get_decoder_priority(cls, codec):
        return get_settings().get(DECODERS_PREFIX + codec.urn + '/priority',
                                  codec.default_priority)

    @classmethod
    def set_decoder_priority(cls, codec, priority):
        get_settings().set(DECODERS_PREFIX + codec.urn + '/priority',
                           int(priority))
        cls.reset_codecs()

    @classmethod
    def _reset_for_tests(cls):
        """Clear all loaded state (test helper)."""
        cls.plugin_modules = None
        cls.plugins = None
        cls.enabled_plugins = None
        cls.codecs = []
        cls.codecs_by_priority = []
