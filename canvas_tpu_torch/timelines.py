"""The two timelines the port renders, built from the port's own classes:

- ``build_timeline(length)``: the headline 10-layer 1080p composite
  (``bench.py:27-67``): a full-frame background, five animated gain
  cards, two animated scalers, a crossfade and a white strip;
- ``mixed_timeline(length)``: the mixed-content timeline of
  ``benchmarks.py`` config7 (``benchmarks.py:605-639``): the headline
  with layers 2, 4 and 6 replaced by 720x480 4:1:1 DV clips, decoded on
  the host, through animated 1.25x scalers.

Both match the JAX package's builders item for item, so a planner given
either one plans the IR the JAX package plans for its own.
"""

import numpy as np

from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.coded import (CodedImage, CodedImageSource,
                                    DVReconstructionFilter)
from canvas_tpu_torch.framefuncs import LerpFunc, LinearFrameFunc
from canvas_tpu_torch.sources import (SolidColorVideoSource,
                                      VideoGainOffsetFilter, VideoMixFilter,
                                      VideoScaler, VideoWorkspace)

__all__ = ['build_timeline', 'mixed_timeline']


def build_timeline(length=1024):
    """10-layer 1080p timeline: solids with animated windows/colors,
    opacity (gain) animation, and two animated scalers (affine motion)."""
    ws = VideoWorkspace()
    # Layer 0: full-frame background
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.12, 1.0)),
           x=0, length=length, z=0)
    # Layers 1-5: animated color cards at varying windows/opacity
    for i in range(5):
        color = LerpFunc((0.9 - 0.1 * i, 0.1 * i, 0.3, 0.9),
                         (0.1 * i, 0.8, 0.9 - 0.1 * i, 0.4), length)
        win = box2i(60 * i, 40 * i, 60 * i + 900, 40 * i + 600)
        layer = VideoGainOffsetFilter(
            SolidColorVideoSource(color, window=win),
            gain=LinearFrameFunc(0.3 / length, 0.7), offset=0.0)
        ws.add(source=layer, x=0, length=length, z=i + 1)
    # Layers 6-7: animated scalers (affine motion: translate + zoom)
    for i in range(2):
        base = SolidColorVideoSource((0.2, 0.5 + 0.2 * i, 0.8, 0.8),
                                     window=box2i(0, 0, 479, 269))
        sc = VideoScaler(
            base,
            target_point=LerpFunc((200 + 300 * i, 150), (900, 700), length),
            source_point=(0.0, 0.0),
            scale_factors=LerpFunc((1.0, 1.0), (1.8, 1.8), length),
            source_rect=box2i(0, 0, 479, 269))
        ws.add(source=sc, x=0, length=length, z=6 + i)
    # Layers 8-9: crossfading cards
    mix = VideoMixFilter(
        SolidColorVideoSource((1.0, 0.4, 0.1, 0.6),
                              window=box2i(400, 300, 1500, 900)),
        SolidColorVideoSource((0.1, 0.4, 1.0, 0.6),
                              window=box2i(400, 300, 1500, 900)),
        LerpFunc((0.0,), (1.0,), length))
    ws.add(source=mix, x=0, length=length, z=8)
    ws.add(source=SolidColorVideoSource((1, 1, 1, 0.08),
                                        window=box2i(0, 980, 1919, 1079)),
           x=0, length=length, z=9)
    return ws


class RolledDV(CodedImageSource):
    """Seeded 720x480 4:1:1 planes (``RandomState(7)``, as config7's), rolled
    down by the frame index, so every frame's planes differ."""

    def __init__(self):
        rng = np.random.RandomState(7)
        self.planes = (rng.randint(16, 236, (480, 720)).astype(np.uint8),
                       rng.randint(16, 241, (480, 180)).astype(np.uint8),
                       rng.randint(16, 241, (480, 180)).astype(np.uint8))

    def get_frame(self, frame_index, quality=0):
        return CodedImage([np.roll(p, frame_index, axis=0)
                           for p in self.planes])


def mixed_timeline(length=256):
    """10-layer 1080p with 3 staged coded DV layers (reconstruct ->
    scaler), the rest solids/gain/crossfade; coded planes differ per
    frame (rolled), so every unique frame's planes really cross
    host->device once."""
    ws = build_timeline(length)
    for z, (tx, ty) in zip((2, 4, 6), ((0, 0), (640, 120), (960, 480))):
        clip = VideoScaler(
            DVReconstructionFilter(RolledDV()),
            target_point=LerpFunc((tx, ty), (tx + 60, ty + 40), length),
            source_point=(0.0, -1.0),
            scale_factors=(1.25, 1.25),
            source_rect=box2i(0, -1, 719, 478))
        for item in [it for it in ws if it.z == z]:
            ws.remove(item)
        ws.add(source=clip, x=0, length=length, z=z)
    return ws
