"""Time ruler tick math (model of fluggo/editor/ui/ruler.py).

Given a scale (pixels per frame), a left frame, and a timecode scheme,
compute minor/medium/major tick positions and labels — the part of the
reference's TimeRuler widget that isn't painting.
"""

import fractions

from canvas_tpu_torch import timecode as timecode_mod

__all__ = ['TimeRulerModel']


class TimeRulerModel:
    def __init__(self, timecode=None, scale=fractions.Fraction(1),
                 frame_rate=fractions.Fraction(30, 1)):
        self.timecode = timecode or timecode_mod.Frames()
        self.frame_rate = fractions.Fraction(frame_rate)
        self.left_frame = 0
        self.minor_tick = None
        self.medium_tick = None
        self.major_tick = None
        self.set_scale(scale)

    def set_scale(self, scale):
        """Scale in pixels per frame (ruler.py:66-90): choose the densest
        tick intervals that keep >= 5px (minor), >= 15px (medium) and
        >= 50px (major) spacing."""
        self.scale = fractions.Fraction(scale)
        ticks = self.timecode.get_major_ticks() or \
            [1, 10, 100, 1000, 10000, 100000]

        self.minor_tick = None
        self.medium_tick = None
        self.major_tick = ticks[-1]

        for tick in ticks:
            px = float(self.scale * tick)
            if self.minor_tick is None and px >= 5.0:
                self.minor_tick = tick
            if self.medium_tick is None and px >= 15.0:
                self.medium_tick = tick
            if px >= 50.0:
                self.major_tick = tick
                break

        if self.medium_tick is None:
            self.medium_tick = self.major_tick
        if self.minor_tick is None:
            self.minor_tick = self.medium_tick

    def set_left_frame(self, frame):
        # fractional frames supported: the timeline scrolls in float
        # seconds, and quantizing here shifted every tick/label up to a
        # frame-width off the content drawn at the unquantized offset
        self.left_frame = frame if isinstance(frame, float) else int(frame)

    def frame_at_x(self, x):
        """Pixel x -> frame (ruler.py:56-60)."""
        return int(round(float(fractions.Fraction(x) / self.scale) +
                         self.left_frame))

    def x_at_frame(self, frame):
        return float(self.scale * (frame - self.left_frame))

    def ticks_in_width(self, width_px):
        """Yield (x_px, kind, label_or_None) for visible ticks; kind in
        ('minor', 'medium', 'major'). Major ticks carry labels."""
        first = self.left_frame
        last = self.frame_at_x(width_px)
        result = []
        import math
        frame = (int(math.floor(first)) // self.minor_tick) \
            * self.minor_tick
        while frame <= last:
            if frame >= first:
                x = self.x_at_frame(frame)
                if frame % self.major_tick == 0:
                    result.append((x, 'major', self.timecode.format(frame)))
                elif frame % self.medium_tick == 0:
                    result.append((x, 'medium', None))
                else:
                    result.append((x, 'minor', None))
            frame += self.minor_tick
        return result
