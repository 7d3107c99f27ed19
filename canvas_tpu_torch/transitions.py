"""Transition factories: the port's copy of ``canvas_tpu/transitions.py``
(the reference's fluggo/media/transitions.py:24-30)."""

from canvas_tpu_torch.framefuncs import LinearFrameFunc
from canvas_tpu_torch.sources import VideoMixFilter

__all__ = ['Transition', 'Crossfade']


class Transition:
    def create_source(self, source_a, source_b, length):
        raise NotImplementedError


class Crossfade(Transition):
    """Linear crossfade over *length* frames."""

    def create_source(self, source_a, source_b, length):
        return VideoMixFilter(src_a=source_a, src_b=source_b,
                              mix_b=LinearFrameFunc(a=1.0 / length, b=0.0))
