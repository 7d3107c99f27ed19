"""Software paint layer for the editor timeline canvas.

The reference paints its timeline with QGraphicsScene items
(fluggo/editor/ui/canvas/scene.py, clipitem.py,
scrollview.py) — Qt-only. Here the paint layer is a toolkit-independent
NumPy rasterizer producing (H, W, 4) u8 BGRA frames: the Qt/GTK widget
shims (and tests, and headless CI) all blit the same pixels. It draws
what the reference's canvas draws: lane stripes, clip rectangles with
type colors + title bars, selection outlines, thumbnail strips inside
video clips, snap markers, the time ruler with timecode labels, and the
playhead.
"""

import numpy as np

__all__ = ['CanvasPainter', 'THEME']

# BGRA colors (display byte order, matching the playback sinks)
THEME = {
    'background': (34, 30, 28, 255),
    'lane_even': (42, 38, 36, 255),
    'lane_odd': (48, 43, 41, 255),
    'ruler_bg': (26, 23, 22, 255),
    'tick_minor': (80, 76, 72, 255),
    'tick_medium': (120, 114, 108, 255),
    'tick_major': (190, 184, 176, 255),
    'clip_video': (96, 60, 36, 255),
    'clip_audio': (52, 96, 48, 255),
    'clip_title': (128, 84, 56, 255),
    # expanded-sequence container: the reference's light fill behind
    # the A/B roll (canvas/sequence.py:255, rgbf 0.9, 0.9, 0.8)
    'sequence_bg': (204, 230, 230, 255),
    'clip_border': (16, 14, 13, 255),
    'selection': (64, 180, 255, 255),
    'snap': (0, 220, 255, 255),
    'playhead': (48, 48, 230, 255),
    'label': (210, 205, 200, 255),
}

# 4x6 bitmap glyphs for ruler timecode labels (rows of 4 bits each).
_GLYPHS = {
    '0': (0x6, 0x9, 0x9, 0x9, 0x9, 0x6),
    '1': (0x2, 0x6, 0x2, 0x2, 0x2, 0x7),
    '2': (0x6, 0x9, 0x1, 0x6, 0x8, 0xF),
    '3': (0x6, 0x9, 0x2, 0x1, 0x9, 0x6),
    '4': (0x9, 0x9, 0x9, 0xF, 0x1, 0x1),
    '5': (0xF, 0x8, 0xE, 0x1, 0x9, 0x6),
    '6': (0x6, 0x8, 0xE, 0x9, 0x9, 0x6),
    '7': (0xF, 0x1, 0x2, 0x2, 0x4, 0x4),
    '8': (0x6, 0x9, 0x6, 0x9, 0x9, 0x6),
    '9': (0x6, 0x9, 0x9, 0x7, 0x1, 0x6),
    ':': (0x0, 0x2, 0x0, 0x0, 0x2, 0x0),
    ';': (0x0, 0x2, 0x0, 0x0, 0x2, 0x4),
    '.': (0x0, 0x0, 0x0, 0x0, 0x0, 0x2),
    '-': (0x0, 0x0, 0xF, 0x0, 0x0, 0x0),
    '+': (0x0, 0x2, 0x7, 0x2, 0x0, 0x0),
}


def _draw_text(buf, x, y, text, color):
    """Blit 4x6 glyph text at (x, y); unknown characters skip."""
    H, W = buf.shape[:2]
    for ch in text:
        glyph = _GLYPHS.get(ch)
        if glyph is not None:
            for row, bits in enumerate(glyph):
                py = y + row
                if not (0 <= py < H):
                    continue
                for col in range(4):
                    if bits & (0x8 >> col):
                        px = x + col
                        if 0 <= px < W:
                            buf[py, px] = color
        x += 5


def _fill(buf, x0, y0, x1, y1, color):
    """Filled rect, [x0, x1) x [y0, y1), clipped."""
    H, W = buf.shape[:2]
    x0, x1 = max(0, int(x0)), min(W, int(x1))
    y0, y1 = max(0, int(y0)), min(H, int(y1))
    if x0 < x1 and y0 < y1:
        buf[y0:y1, x0:x1] = color


def _outline(buf, x0, y0, x1, y1, color, thickness=1):
    t = thickness
    _fill(buf, x0, y0, x1, y0 + t, color)
    _fill(buf, x0, y1 - t, x1, y1, color)
    _fill(buf, x0, y0, x0 + t, y1, color)
    _fill(buf, x1 - t, y0, x1, y1, color)


class CanvasPainter:
    """Rasterizes a CanvasSceneModel through a ViewTransformModel.

    ruler: optional TimeRulerModel drawn as a strip at the top;
    thumbnails: optional {item: (H, W, 4) u8 BGRA} blitted into video
    clips (the ThumbnailPainter output).
    """

    ruler_height = 18
    title_height = 5

    def __init__(self, scene, transform, ruler=None, theme=None):
        self.scene = scene
        self.transform = transform
        self.ruler = ruler
        self.theme = dict(THEME, **(theme or {}))

    def paint(self, width_px, height_px, playhead_frame=None,
              playhead_rate=None, thumbnails=None):
        """Render the canvas into a fresh (height_px, width_px, 4) u8
        BGRA buffer."""
        t = self.theme
        buf = np.empty((height_px, width_px, 4), np.uint8)
        buf[:] = t['background']

        # Content (lanes/clips) draws offset below the ruler strip.
        top = self.ruler_height if self.ruler is not None else 0

        # Lane stripes
        lane_h = self.transform.pixels_per_lane
        first_lane = int(np.floor(self.transform.view_to_scene(0, 0)[1]))
        lane = first_lane
        while True:
            y0 = self.transform.scene_to_view(0, lane)[1] + top
            if y0 >= height_px:
                break
            y1 = y0 + lane_h
            if y1 > top:
                _fill(buf, 0, max(y0, top), width_px, y1,
                      t['lane_even'] if lane % 2 == 0 else t['lane_odd'])
            lane += 1

        # Items, bottom z first so higher z paints on top
        views = sorted(self.scene.views.values(),
                       key=lambda v: -getattr(v.item, 'z', 0))
        for view in views:
            (x, y, w, h) = view.rect
            x0, y0 = self.transform.scene_to_view(x, y)
            x1, y1 = self.transform.scene_to_view(x + w, y + h)
            y0 += top
            y1 += top
            if x1 <= 0 or x0 >= width_px or y1 <= top or y0 >= height_px:
                continue
            # CLIP to the viewport instead of re-anchoring: cy0 is the
            # clip's TRUE top (possibly above the ruler line) — the
            # title bar scrolls out of view with the clip, and the
            # thumbnail keeps its true geometry and crops (clamping
            # before the blit made it re-anchor and re-scale while
            # scrolling).
            cy0 = y0
            y0 = max(y0, top)
            kind = view.item.type() if callable(
                getattr(view.item, 'type', None)) else 'video'
            body = t['clip_audio'] if kind == 'audio' else t['clip_video']
            subs = (view.sub_rects()
                    if hasattr(view, 'sub_rects') else None)
            if subs is not None:
                # Expanded sequence: light container + A/B sub-clips
                # (transitions visible as the horizontal overlap), the
                # reference's expanded VideoSequence rendering
                # (canvas/sequence.py:248-257)
                _fill(buf, x0, y0, x1, y1, t['sequence_bg'])
                for (_sub, (sx, sy, sw, sh)) in subs:
                    sx0, sy0 = self.transform.scene_to_view(sx, sy)
                    sx1, sy1 = self.transform.scene_to_view(sx + sw,
                                                            sy + sh)
                    sy0 = max(sy0 + top, top)
                    sy1 += top
                    if sx1 <= 0 or sx0 >= width_px or sy1 <= sy0:
                        continue
                    _fill(buf, sx0, sy0, sx1, sy1, body)
                    _fill(buf, sx0, sy0, sx1,
                          min(sy0 + self.title_height, sy1),
                          t['clip_title'])
                    _outline(buf, sx0, sy0, sx1, sy1, t['clip_border'])
                _outline(buf, x0, y0, x1, y1,
                         t['selection'] if view.selected
                         else t['clip_border'])
                continue
            _fill(buf, x0, y0, x1, y1, body)
            _fill(buf, x0, max(cy0, top), x1,
                  min(max(cy0 + self.title_height, top), y1),
                  t['clip_title'])
            thumb = (thumbnails or {}).get(view.item)
            if thumb is not None:
                self._blit_thumb(buf, thumb,
                                 x0, cy0 + self.title_height, x1, y1,
                                 clip_top=top)
            _outline(buf, x0, y0, x1, y1,
                     t['selection'] if view.selected else t['clip_border'])

        # Snap markers ('x' = vertical bar at a time, 'y' = horizontal
        # bar at a lane — the reference's Horizontal/VerticalSnapMarker
        # pair; 'y' was silently dropped)
        for marker in getattr(self.transform, 'markers', ()):
            if marker.axis == 'x':
                px = self.transform.scene_to_view(marker.position, 0)[0]
                _fill(buf, px, top, px + 1, height_px, t['snap'])
            elif marker.axis == 'y':
                py = self.transform.scene_to_view(0, marker.position)[1]
                _fill(buf, 0, top + py, width_px, top + py + 1, t['snap'])

        # Ruler strip
        if self.ruler is not None:
            _fill(buf, 0, 0, width_px, top, t['ruler_bg'])
            for (px, kind, label) in self.ruler.ticks_in_width(width_px):
                px = int(px)
                if kind == 'major':
                    _fill(buf, px, 2, px + 1, top, t['tick_major'])
                    if label:
                        _draw_text(buf, px + 3, 3, label, t['label'])
                elif kind == 'medium':
                    _fill(buf, px, top - 8, px + 1, top, t['tick_medium'])
                else:
                    _fill(buf, px, top - 4, px + 1, top, t['tick_minor'])

        # Playhead
        if playhead_frame is not None:
            rate = float(playhead_rate or 30.0)
            px = self.transform.scene_to_view(playhead_frame / rate, 0)[0]
            _fill(buf, px, 0, px + 1, height_px, t['playhead'])

        return buf

    @staticmethod
    def _blit_thumb(buf, thumb, x0, y0, x1, y1, clip_top=0):
        """Nearest-neighbor blit of a BGRA thumb into the clip body.

        x0/y0 are the thumb's TRUE anchor (may lie off-viewport); the
        blit crops to the buffer instead of re-anchoring, so a clip
        scrolling off-screen shows a cropped thumbnail at stable
        scale."""
        x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
        th, tw = thumb.shape[:2]
        h = y1 - y0
        if h <= 1 or x1 - x0 <= 1:
            return
        w = max(1, int(h * tw / th))          # aspect from TRUE height
        w = min(w, x1 - x0)
        ys = (np.arange(h) * th // h)
        xs = (np.arange(w) * tw // w)
        # crop source rows/cols for the off-viewport part
        vy0 = max(y0, int(clip_top), 0)
        vx0 = max(x0, 0)
        vy1 = min(y0 + h, buf.shape[0])
        vx1 = min(x0 + w, buf.shape[1])
        if vy1 <= vy0 or vx1 <= vx0:
            return
        buf[vy0:vy1, vx0:vx1] = \
            thumb[ys[vy0 - y0:vy1 - y0]][:, xs[vx0 - x0:vx1 - x0]]
