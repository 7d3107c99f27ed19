"""The timelines the port renders, built from the port's own classes:

- ``build_timeline(length)``: the headline 10-layer 1080p composite
  (``bench.py:27-67``): a full-frame background, five animated gain
  cards, two animated scalers, a crossfade and a white strip;
- ``mixed_timeline(length)``: the mixed-content timeline of
  ``benchmarks.py`` config7 (``benchmarks.py:605-639``): the headline
  with layers 2, 4 and 6 replaced by 720x480 4:1:1 DV clips, decoded on
  the host, through animated 1.25x scalers;
- ``crossfade_timeline(length)``: the two-clip crossfade of
  ``benchmarks.py`` config2 (``benchmarks.py:240-252``, rendered there
  at 1920x1080): two lerped solids through ``VideoMixFilter`` under a
  mix lerped from 0 to 1;
- ``transfer_timeline(length)``: the single clip of ``benchmarks.py``
  config1 (``benchmarks.py:225-237``, rendered there at 1280x720): a
  solid whose color ramps from black to white, through the rec709 ->
  linear transfer;
- ``pulldown_clip()``: the clip of ``benchmarks.py`` config3
  (``benchmarks.py:255-275``): a 720x480 4:1:1 DV clip reconstructed
  under 2:3 pulldown removal, rendered at ``PULLDOWN_WINDOW``;
- ``planar_clip(length)``: the graph of ``benchmarks.py`` config8
  (``benchmarks.py:705-728``): 1920x1080 4:2:0 planes through the
  generic planar reconstruction, with seeded planes in the decoder's
  place;
- ``decoded_planar_clip(path, length)``: config8 itself: the same graph
  over ``libav.AVVideoDecoder`` of an MPEG-4 file that ``write_video``
  writes first;
- ``CONFIG6_WINDOW``: the 4K window ``benchmarks.py`` config6 and
  config6b render ``build_timeline()`` at (``benchmarks.py:549-602``);
- ``editor_headline(length)``: the headline as an editor project: each
  of its ten layers a ``Clip`` in a lane of its own of a 1920x1080
  ``Space``, which the editor's graph managers turn back into the same
  composite (the same plan signature, bit-equal frames);
- ``editor_cut(length)``: the editor's own shape of content: the
  headline's background, a ``Sequence`` of three DV clips with two
  12-frame crossfades, and the white strip; ``editor_video(asset)``
  brings a project's ``SpaceAsset`` online and gives its video stream.

Each matches the JAX package's builder item for item, so a planner given
one plans the IR the JAX package plans for its own.
"""

import os
from fractions import Fraction

import numpy as np

from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.coded import (CodedImage, CodedImageSource,
                                    DVReconstructionFilter,
                                    PlanarReconstructionFilter,
                                    Pulldown23RemovalFilter)
from canvas_tpu_torch.framefuncs import LerpFunc, LinearFrameFunc
from canvas_tpu_torch.sources import (SolidColorVideoSource,
                                      VideoColorTransferFilter,
                                      VideoGainOffsetFilter, VideoMixFilter,
                                      VideoScaler, VideoWorkspace)

__all__ = ['CONFIG6_WINDOW', 'CUT_CLIP', 'CUT_TRANSITION', 'EDITOR_LAYERS',
           'PULLDOWN_WINDOW', 'build_timeline', 'crossfade_timeline',
           'decoded_planar_clip', 'editor_cut', 'editor_headline',
           'editor_video',
           'mixed_timeline', 'planar_clip', 'pulldown_clip',
           'transfer_timeline']

#: The window config3 renders ``pulldown_clip`` at: DV's picture, whose
#: line zero belongs to the first field (row -1 on top).
PULLDOWN_WINDOW = box2i(0, -1, 719, 478)

#: The 3840x2160 window config6 and config6b render the headline at.
CONFIG6_WINDOW = box2i(0, 0, 3839, 2159)


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


def crossfade_timeline(length=1024):
    """A red-to-green solid crossfading into a blue-to-yellow one over
    *length* frames, the mix lerped from 0 to 1."""
    return VideoMixFilter(
        SolidColorVideoSource(LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), length)),
        SolidColorVideoSource(LerpFunc((0, 0, 1, 1), (1, 1, 0, 1), length)),
        LerpFunc((0.0,), (1.0,), length))


def transfer_timeline(length=1024):
    """A solid ramping from opaque black to opaque white over *length*
    frames, through the rec709 -> linear (scene) transfer."""
    return VideoColorTransferFilter(
        SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), length)),
        'rec709_to_linear_scene')


class FixedDV(CodedImageSource):
    """Seeded 720x480 4:1:1 planes (``RandomState(0)``, as config3's), the
    same for every frame."""

    def __init__(self):
        rng = np.random.RandomState(0)
        self.planes = (rng.randint(16, 236, (480, 720)).astype(np.uint8),
                       rng.randint(16, 241, (480, 180)).astype(np.uint8),
                       rng.randint(16, 241, (480, 180)).astype(np.uint8))

    def get_frame(self, frame_index, quality=0):
        return CodedImage(list(self.planes))


def pulldown_clip():
    """DV 4:1:1 reconstruction under 2:3 pulldown removal at cadence
    offset 0: three of four frames are one source frame, the fourth
    interleaves the fields of two. Render it at ``PULLDOWN_WINDOW``."""
    return Pulldown23RemovalFilter(DVReconstructionFilter(FixedDV()), 0)


class RolledPlanar(CodedImageSource):
    """Seeded 4:2:0 planes of *width* x *height* (``RandomState(8)``),
    rolled down by the frame index, for frames 0..length-1; None
    outside, as a decoder past the end of its file."""

    def __init__(self, length, width=1920, height=1080):
        rng = np.random.RandomState(8)
        ch, cw = (height + 1) // 2, (width + 1) // 2
        self.length = int(length)
        self.planes = (rng.randint(16, 236, (height, width)).astype(np.uint8),
                       rng.randint(16, 241, (ch, cw)).astype(np.uint8),
                       rng.randint(16, 241, (ch, cw)).astype(np.uint8))

    def get_frame(self, frame_index, quality=0):
        if not 0 <= frame_index < self.length:
            return None
        return CodedImage([np.roll(p, frame_index, axis=0)
                           for p in self.planes])


def planar_clip(length=64):
    """*length* frames of decoded 1920x1080 4:2:0 video through
    ``PlanarReconstructionFilter(width=1920, height=1080)``.

    config8 decodes an MPEG-4 file with ``libav.AVVideoDecoder``
    (``decoded_planar_clip``); here ``RolledPlanar`` stands in for it:
    seeded planes rolled by the frame index, so every frame's planes
    differ and really cross to the device. What is left out is the
    decode itself: a number taken on this clip is one with the decode
    bypassed."""
    return PlanarReconstructionFilter(RolledPlanar(length), width=1920,
                                      height=1080)


def decoded_planar_clip(path, length=64, width=1920, height=1080,
                        device=None):
    """config8's graph over a real decode (``benchmarks.py:705-728``):
    ``PlanarReconstructionFilter(AVVideoDecoder(path))`` at *width* x
    *height*. When *path* does not exist it is written first, as config8
    writes it: ``write_video`` of a solid ramping from opaque black to
    opaque white over 64 frames (rendered on *device*), *length*
    frames, 25 fps, MPEG-4 at 8 Mb/s in AVI."""
    from canvas_tpu_torch import libav
    if not os.path.exists(path):
        src = SolidColorVideoSource(LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), 64))
        libav.write_video(path, src, None, 0, length,
                          frame_size=(width, height),
                          frame_rate=Fraction(25), video_codec='mpeg4',
                          bit_rate=8_000_000, format='avi', device=device)
    return PlanarReconstructionFilter(libav.AVVideoDecoder(path),
                                      width=width, height=height)


#: The asset names of the headline's ten layers in ``editor_headline``,
#: bottom (workspace z 0) to top (z 9).
EDITOR_LAYERS = ('background', 'card1', 'card2', 'card3', 'card4', 'card5',
                 'scaler1', 'scaler2', 'crossfade', 'strip')


def _editor_format():
    from canvas_tpu_torch.editor import plugins
    video = plugins.VideoFormat(full_frame=box2i(0, 0, 1919, 1079),
                                frame_rate=Fraction(25))
    audio = plugins.AudioFormat(sample_rate=48000,
                                channel_assignment=['FrontLeft',
                                                    'FrontRight'])
    return video, audio


def _runtime_asset(assets, name, source, video_format):
    """An asset *name* in *assets* whose one stream, 'video', is
    *source* behind a live ``plugins.VideoStream``; its stream ref."""
    from canvas_tpu_torch.editor import model, plugins
    stream = plugins.VideoStream(source, video_format, name='video')
    assets[name] = model.RuntimeSourceAsset(
        model.RuntimeSource(name, {'video': stream}))
    return model.AssetStreamRef(asset_path=name, stream='video')


def _project(name, clips, assets, video_format, audio_format):
    from canvas_tpu_torch.editor import model
    space = model.Space(name, video_format, audio_format)
    space[:] = clips
    space_asset = model.SpaceAsset(space, name=name)
    assets[name] = space_asset
    return assets, space_asset


def editor_headline(length=1024):
    """``build_timeline(length)`` as an editor project: each workspace
    item is a video ``Clip`` over a ``RuntimeSourceAsset`` (named by
    ``EDITOR_LAYERS``) in a lane of its own, lane ``9 - z`` for the
    item at workspace z, so the graph managers' stacking key ``(-y,
    -z)`` keeps the headline's order. Returns the project's
    ``AssetList`` and its ``SpaceAsset`` ('headline')."""
    from canvas_tpu_torch.editor import model
    video_format, audio_format = _editor_format()
    assets = model.AssetList()
    clips = []
    for item in sorted(build_timeline(length), key=lambda it: it.z):
        ref = _runtime_asset(assets, EDITOR_LAYERS[item.z], item.source,
                             video_format)
        clips.append(model.Clip(type='video', source=ref, offset=item.offset,
                                x=item.x, y=float(9 - item.z),
                                length=item.length, height=1.0))
    return _project('headline', clips, assets, video_format, audio_format)


#: ``editor_cut``'s sequence: three clips of this many frames, each after
#: the first entering through a crossfade of ``CUT_TRANSITION`` frames.
CUT_CLIP = 64
CUT_TRANSITION = 12


def editor_cut(length=256):
    """The editor's own shape of content at 1080p: lane 2 the
    headline's background solid, lane 1 a ``Sequence`` of three
    ``CUT_CLIP``-frame clips over the mixed timeline's three DV sources
    (``VideoScaler(DVReconstructionFilter(RolledDV()))`` at 1.25x, as
    ``mixed_timeline(length)`` builds them) with ``CUT_TRANSITION``-frame
    crossfades between them (frames 52..63 and 104..115), lane 0 the
    headline's white strip. Returns the project's ``AssetList`` and its
    ``SpaceAsset`` ('cut')."""
    from canvas_tpu_torch.editor import model
    video_format, audio_format = _editor_format()
    assets = model.AssetList()
    background = _runtime_asset(
        assets, 'background',
        SolidColorVideoSource((0.1, 0.1, 0.12, 1.0)), video_format)
    strip = _runtime_asset(
        assets, 'strip',
        SolidColorVideoSource((1, 1, 1, 0.08),
                              window=box2i(0, 980, 1919, 1079)),
        video_format)
    items = []
    for i, (tx, ty) in enumerate(((0, 0), (640, 120), (960, 480))):
        clip = VideoScaler(
            DVReconstructionFilter(RolledDV()),
            target_point=LerpFunc((tx, ty), (tx + 60, ty + 40), length),
            source_point=(0.0, -1.0),
            scale_factors=(1.25, 1.25),
            source_rect=box2i(0, -1, 719, 478))
        ref = _runtime_asset(assets, 'dv%d' % i, clip, video_format)
        items.append(model.SequenceItem(
            source=ref, offset=0, length=CUT_CLIP,
            transition_length=CUT_TRANSITION if i else 0))
    clips = [
        model.Clip(type='video', source=background, x=0, y=2.0,
                   length=length, height=1.0),
        model.Sequence(type='video', items=items, x=0, y=1.0, height=1.0),
        model.Clip(type='video', source=strip, x=0, y=0.0, length=length,
                   height=1.0),
    ]
    return _project('cut', clips, assets, video_format, audio_format)


def editor_video(space_asset):
    """The video stream of an editor project's ``SpaceAsset``: its
    ``SpaceVideoManager``, a source the planner renders, brought online
    first."""
    source = space_asset.get_source()
    if source.offline:
        source.bring_online()
    return source.get_stream('Video')
