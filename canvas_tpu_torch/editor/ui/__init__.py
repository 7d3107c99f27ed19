"""Editor UI layer — headless view-models (the port's counterpart of
``canvas_tpu.editor.ui``).

Rebuild of the reference's fluggo/editor/ui/ with the widget logic
factored out of Qt: each module is the *model* of the corresponding
widget (scene geometry, tick math, thumbnail cache, render job, alert
list), fully testable without a display. A Qt binding, when present,
only needs thin paint/input adapters over these
(canvas_tpu_torch.editor.ui.qt).

What renders frames (``EditorApp``'s playback engines, the thumbnails'
``VideoPullQueue``, ``RenderJob``, ``create_main_window`` and the widget
shims) renders on the card unless given ``device='cpu'``, and raises
without one.
"""

from canvas_tpu_torch.editor.ui.ruler import TimeRulerModel
from canvas_tpu_torch.editor.ui.canvas_models import (
    CanvasItemView, CanvasSceneModel, DragController)
from canvas_tpu_torch.editor.ui.thumbnails import ThumbnailPainter
from canvas_tpu_torch.editor.ui.paint import CanvasPainter
from canvas_tpu_torch.editor.ui.renderprogress import RenderJob
from canvas_tpu_torch.editor.ui.notification import AlertListModel
from canvas_tpu_torch.editor.ui.app import EditorApp
from canvas_tpu_torch.editor.ui.mainwindow import create_main_window

__all__ = ['TimeRulerModel', 'CanvasItemView', 'CanvasSceneModel',
           'DragController', 'ThumbnailPainter', 'CanvasPainter',
           'RenderJob', 'AlertListModel', 'EditorApp', 'create_main_window']
