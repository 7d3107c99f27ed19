"""Alert list model: rows of active alerts for a dock/panel.

Model of fluggo/editor/ui/notificationwidget.py (:27-122):
follows an AlertPublisher (usually a top-level alert manager), keeps an
ordered list of alerts, and signals row changes.
"""

from canvas_tpu_torch.editor.plugins import AlertPublisher
from canvas_tpu_torch.signal import Signal

__all__ = ['AlertListModel']


class AlertListModel(AlertPublisher):
    """Follows other publishers and exposes their alerts as a stable,
    ordered list of rows."""

    def __init__(self, source_publisher=None):
        AlertPublisher.__init__(self)
        self.rows_changed = Signal()
        self._rows = []
        self.alert_added.connect(self._on_added)
        self.alert_removed.connect(self._on_removed)
        if source_publisher is not None:
            self.follow_alerts(source_publisher)

    def _on_added(self, alert):
        self._rows.append(alert)
        self.rows_changed()

    def _on_removed(self, alert):
        try:
            self._rows.remove(alert)
        except ValueError:
            pass
        self.rows_changed()

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        return self._rows[i]

    def row_text(self, i):
        alert = self._rows[i]
        return str(alert)

    def row_icon(self, i):
        return self._rows[i].icon

    def row_actions(self, i):
        return self._rows[i].actions
