"""Timecode formatting/parsing.

Capability match for fluggo/media/timecode.py:21-161:
plain frame counts, hh:mm:ss:ff at an integer nominal rate, and NTSC
drop-frame. Used by the editor's time ruler and by export tooling.
"""

__all__ = ['Timecode', 'Frames', 'TimeAndFrames', 'NtscDropFrame']


class Timecode:
    """Interface: format(frame) -> str, parse(str) -> frame, major ticks."""

    def format(self, frame):
        raise NotImplementedError

    def parse(self, timecode):
        raise NotImplementedError

    def get_major_ticks(self):
        """Frame counts (small to large) that separate significant frames."""
        return []


class Frames(Timecode):
    """Plain frame numbers."""

    def get_major_ticks(self):
        # Decimal ticks for plain frame numbers (the reference leaves
        # this empty and its ruler never pairs Frames with tick math;
        # we give the ruler something sensible)
        return [1, 10, 100, 1000, 10000, 100000]

    def format(self, frame):
        return str(frame)

    def parse(self, timecode):
        return int(timecode)


class TimeAndFrames(Timecode):
    """hh:mm:ss:ff with an integer nominal frames-per-second.

    If the nominal rate differs from the true frame rate (e.g. 30 vs
    30000/1001) this timecode drifts from the wall clock; use
    :class:`NtscDropFrame` for NTSC material.
    """

    def __init__(self, frames_per_second, frames_separator=':'):
        self.frames_per_second = int(frames_per_second)
        self.frames_separator = frames_separator

    def format(self, frame):
        rem, frames = divmod(abs(frame), self.frames_per_second)
        rem, seconds = divmod(rem, 60)
        hours, minutes = divmod(rem, 60)
        text = '{0:02}:{1:02}:{2:02}{sep}{3:02}'.format(
            hours, minutes, seconds, frames, sep=self.frames_separator)
        return '-' + text if frame < 0 else text

    def parse(self, timecode):
        if not timecode:
            return 0

        negative = timecode.startswith('-')
        timecode = timecode.lstrip('-').replace(self.frames_separator, ':')

        fields = reversed(timecode.split(':'))
        multipliers = [1, self.frames_per_second, 60, 60]
        result = 0
        scale = 1

        for sig, value in zip(multipliers, fields):
            scale *= sig
            result += scale * int(value)

        return -result if negative else result

    def get_major_ticks(self):
        fps = self.frames_per_second
        return [fps, fps * 60, fps * 60 * 60]


class NtscDropFrame(TimeAndFrames):
    """NTSC drop-frame timecode (skips ff 00/01 each minute except every 10th).

    Keeps pace with the wall clock for 30000/1001 fps material.
    """

    def __init__(self, frames_separator=';'):
        TimeAndFrames.__init__(self, 30, frames_separator=frames_separator)

    def format(self, frame):
        # Canonical SMPTE drop-frame conversion (17982 frames per true
        # ten-minute block, 1798 per dropping minute). The reference's
        # naive frame//1800 boundaries produce INVALID dropped labels
        # from minute 2 on (e.g. 00:02:00;00 for frame 3598, which
        # drop-frame timecode skips; correct is 00:02:00;02) and drift
        # ~16 frames per 10-minute block from any external deck/NLE —
        # a deliberate reference-bug fix.
        tens, m = divmod(frame, 17982)
        if m < 2:
            m = 2
        adjusted = frame + 18 * tens + 2 * ((m - 2) // 1798)
        return TimeAndFrames.format(self, adjusted)

    def parse(self, timecode):
        label = TimeAndFrames.parse(self, timecode)
        minutes = label // 1800
        return label - 2 * (minutes - minutes // 10)
