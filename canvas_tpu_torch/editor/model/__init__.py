"""Editor document model (reference fluggo.editor.model)."""

from canvas_tpu_torch.editor.model.items import (  # noqa: F401
    Anchor, Item, Clip, PlaceholderItem, Sequence, SequenceItem)
from canvas_tpu_torch.editor.model.space import Space  # noqa: F401
from canvas_tpu_torch.editor.model.assets import (  # noqa: F401
    Asset, SpaceAsset, PluginSource, PluginSourceAsset, RuntimeSource,
    RuntimeSourceAsset, AssetStreamRef, AssetList, Project)
from canvas_tpu_torch.editor.model.connectors import (  # noqa: F401
    VideoSourceRefConnector, AudioSourceRefConnector)
from canvas_tpu_torch.editor.model.undo import (  # noqa: F401
    UndoCommand, UndoStack)
from canvas_tpu_torch.editor.model.commands import *  # noqa: F401,F403
from canvas_tpu_torch.editor.model.manip import (  # noqa: F401
    ClipManipulator, SequenceItemGroupManipulator, SequenceManipulator,
    ItemManipulator)
