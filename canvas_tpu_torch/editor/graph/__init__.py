"""Graph compilers: editor model -> engine graph, kept in sync.

Rebuild of the reference's fluggo/editor/graph/ (video.py, audio.py).
"""

from canvas_tpu_torch.editor.graph.video import (  # noqa: F401
    SpaceVideoManager, SequenceVideoManager)
from canvas_tpu_torch.editor.graph.audio import (  # noqa: F401
    SpaceAudioManager, SequenceAudioManager)
