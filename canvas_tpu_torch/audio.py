"""Audio engine: sample-range frame algebra, sources, sequence, workspace
(the port's copy of ``canvas_tpu/audio.py``, NumPy throughout).

Port of the reference's audio stack:
  * kernels  — src/cprocess/audio_mix.c (copy/attenuate/
    overwrite/mix_add and the pull variant) with identical window-result
    semantics, validated against the C test suite's cases
    (src/tests/test_audio_mix.c).
  * sources  — src/process/AudioSource.c, AudioFrame.c,
    AudioPassThroughFilter.c, AudioSequence.c, AudioWorkspace.c.

Frames are float32 NumPy arrays shaped (samples, channels), indexed by
absolute sample number relative to ``full_min_sample`` (framework.h:290-320).
Like the video side, we keep data outside the current window zeroed where
the C code leaves it undefined. Audio stays host-side: real-time mixing is
tiny compared to video and the reference's own design keeps it sample-exact
CPU work; batched device mixing can ride the render plans if ever needed.

Deviation from the reference: AudioSequence applies each element's *offset*
when pulling (the reference stores it but drops it in getFrame,
AudioSequence.c:80-108 — a latent bug; the video sequence applies it).
"""

import bisect

import numpy as np

from canvas_tpu_torch.sources import _WorkspaceBase

__all__ = ['AudioFrame', 'AudioSource', 'AudioPassThroughFilter',
           'AudioSequence', 'AudioWorkspace',
           'copy_frame', 'copy_frame_attenuate', 'overwrite_frame',
           'attenuate', 'mix_add', 'mix_add_pull']


class AudioSource:
    """Pull-protocol audio source: subclasses implement ``_render(frame)``
    which fills ``frame.data`` and sets the current sample window."""

    def get_frame(self, min_sample, max_sample, channels):
        frame = AudioFrame(min_sample, max_sample, channels)
        self._render(frame)
        return frame

    def _render(self, frame):
        frame.set_empty()


class AudioFrame(AudioSource):
    """A frame of interleaved float samples; also a source (re-pulling
    copies the stored samples)."""

    def __init__(self, min_sample, max_sample, channels, data=None):
        if max_sample < min_sample:
            raise ValueError('max_sample was less than min_sample.')
        if channels < 0:
            raise ValueError('channels was less than zero.')
        self.full_min_sample = int(min_sample)
        self.full_max_sample = int(max_sample)
        self.channels = int(channels)
        length = self.full_max_sample - self.full_min_sample + 1
        if data is None:
            self.data = np.zeros((length, self.channels), dtype=np.float32)
            self.current_min_sample = 0
            self.current_max_sample = -1
        else:
            data = np.asarray(data, dtype=np.float32).reshape(length, self.channels)
            self.data = data
            self.current_min_sample = self.full_min_sample
            self.current_max_sample = self.full_max_sample

    # -- window helpers -----------------------------------------------------

    @property
    def empty(self):
        return self.current_max_sample < self.current_min_sample

    def set_empty(self):
        # The C kernels' empty convention (audio_mix.c:56-59)
        self.current_min_sample = 0
        self.current_max_sample = -1

    def _row(self, sample):
        return sample - self.full_min_sample

    def sample(self, sample, channel):
        """Sample value, or None outside the current window
        (AudioFrame.c:105-120)."""
        if sample < self.current_min_sample or sample > self.current_max_sample:
            return None
        if channel < 0 or channel >= self.channels:
            raise IndexError('Channel index was out of range.')
        return float(self.data[self._row(sample), channel])

    def __len__(self):
        return self.full_max_sample - self.full_min_sample + 1

    def __getitem__(self, i):
        if i < 0 or i >= len(self):
            raise IndexError('Index was out of range.')
        return tuple(float(x) for x in self.data[i])

    def __repr__(self):
        return ('AudioFrame(full=[{0}, {1}], current=[{2}, {3}], '
                'channels={4})'.format(
                    self.full_min_sample, self.full_max_sample,
                    self.current_min_sample, self.current_max_sample,
                    self.channels))

    # -- source protocol -----------------------------------------------------

    def _render(self, frame):
        copy_frame(frame, self, 0)

    # -- ghost views (workspace composite, workspace.c:636-646) --------------

    def ghost(self, full_min, full_max, current_min, current_max):
        """A sub-frame sharing this frame's buffer (numpy view)."""
        g = AudioFrame.__new__(AudioFrame)
        g.full_min_sample = full_min
        g.full_max_sample = full_max
        g.channels = self.channels
        g.current_min_sample = current_min
        g.current_max_sample = current_max
        g.data = self.data[self._row(full_min):self._row(full_max) + 1]
        return g


# --- kernels (audio_mix.c) ---------------------------------------------------

def _adapt_channels(block, channels):
    """Channel-count adaptation: silence extra output channels
    (audio_mix.c:45-50)."""
    in_ch = block.shape[1]
    if in_ch == channels:
        return block
    out = np.zeros((block.shape[0], channels), dtype=np.float32)
    out[:, :min(in_ch, channels)] = block[:, :min(in_ch, channels)]
    return out


def copy_frame(out, in_, offset=0):
    """out <- in shifted by offset (audio_mix.c:24-51)."""
    out.current_min_sample = max(out.full_min_sample,
                                 in_.current_min_sample - offset)
    out.current_max_sample = min(out.full_max_sample,
                                 in_.current_max_sample - offset)
    out.data[:] = 0.0

    if out.current_max_sample < out.current_min_sample:
        return

    src = in_.data[in_._row(out.current_min_sample + offset):
                   in_._row(out.current_max_sample + offset) + 1]
    out.data[out._row(out.current_min_sample):
             out._row(out.current_max_sample) + 1] = \
        _adapt_channels(src, out.channels)


def copy_frame_attenuate(out, in_, factor, offset=0):
    """out <- in * factor (audio_mix.c:53-84)."""
    if factor == 0.0:
        out.set_empty()
        out.data[:] = 0.0
        return
    copy_frame(out, in_, offset)
    if factor != 1.0 and not out.empty:
        sl = slice(out._row(out.current_min_sample),
                   out._row(out.current_max_sample) + 1)
        out.data[sl] *= np.float32(factor)


def overwrite_frame(out, in_, offset=0):
    """Overlay in's current window onto out, silence-filling any gap
    between the two windows (audio_mix.c:86-146)."""
    if in_.empty:
        return

    in_min = max(out.full_min_sample + offset, in_.current_min_sample)
    in_max = min(out.full_max_sample + offset, in_.current_max_sample)

    if in_max < in_min:
        return

    if not out.empty:
        # Zero any gap between the existing window and the incoming one
        # (audio_mix.c:104-119); callers may hand us buffers with
        # arbitrary data outside the current window.
        gap_lo = out.current_max_sample + 1
        gap_hi = min(in_.current_min_sample - offset - 1, out.full_max_sample)
        if gap_hi >= gap_lo:
            out.data[out._row(gap_lo):out._row(gap_hi) + 1] = 0.0

        gap_hi2 = out.current_min_sample - 1
        gap_lo2 = max(in_.current_max_sample - offset + 1, out.full_min_sample)
        if gap_hi2 >= gap_lo2:
            out.data[out._row(gap_lo2):out._row(gap_hi2) + 1] = 0.0

        out.current_min_sample = max(
            out.full_min_sample,
            min(in_.current_min_sample - offset, out.current_min_sample))
        out.current_max_sample = min(
            out.full_max_sample,
            max(in_.current_max_sample - offset, out.current_max_sample))
    else:
        out.current_min_sample = in_min - offset
        out.current_max_sample = in_max - offset

    if out.current_max_sample < out.current_min_sample:
        return

    src = in_.data[in_._row(in_min):in_._row(in_max) + 1]
    out.data[out._row(in_min - offset):out._row(in_max - offset) + 1] = \
        _adapt_channels(src, out.channels)


def attenuate(frame, factor):
    """In-place gain over the current window (audio_mix.c:148-167)."""
    if factor == 1.0:
        return
    if factor == 0.0:
        frame.data[:] = 0.0
        frame.set_empty()
        return
    if not frame.empty:
        sl = slice(frame._row(frame.current_min_sample),
                   frame._row(frame.current_max_sample) + 1)
        frame.data[sl] *= np.float32(factor)


def mix_add(out, a, mix_a, offset=0):
    """out += a * mix_a with window union (audio_mix.c:169-239)."""
    if out.empty:
        copy_frame_attenuate(out, a, mix_a, offset)
        return

    if mix_a == 0.0 or a.empty:
        return

    new_min = max(out.full_min_sample,
                  min(a.current_min_sample - offset, out.current_min_sample))
    new_max = min(out.full_max_sample,
                  max(a.current_max_sample - offset, out.current_max_sample))

    # Zero regions of out's buffer inside the new window but outside out's
    # old window (they may hold arbitrary data); then a single vectorized
    # add replaces the reference's left/middle/right region split
    # (audio_mix.c:200-235).
    if new_min < out.current_min_sample:
        out.data[out._row(new_min):out._row(out.current_min_sample)] = 0.0
    if new_max > out.current_max_sample:
        out.data[out._row(out.current_max_sample) + 1:
                 out._row(new_max) + 1] = 0.0

    a_lo = max(new_min, a.current_min_sample - offset)
    a_hi = min(new_max, a.current_max_sample - offset)

    if a_hi >= a_lo:
        src = a.data[a._row(a_lo + offset):a._row(a_hi + offset) + 1]
        out.data[out._row(a_lo):out._row(a_hi) + 1] += \
            _adapt_channels(src, out.channels) * np.float32(mix_a)

    out.current_min_sample = new_min
    out.current_max_sample = new_max


def mix_add_pull(out, source, mix_a, offset_a=0):
    """Pull *source* and mix it into *out* (audio_mix.c:241-285). The
    source is pulled over out's sample range rebased by offset_a."""
    if out.empty:
        if mix_a == 0.0:
            attenuate(out, 0.0)
            return
        # Rebase out's bounds, pull directly, unshift (the reference's
        # allocation-free trick, audio_mix.c:252-265). Python sources may
        # *assign* frame.data instead of writing in place; if out is a
        # ghost view of a parent buffer, copy the result back into it.
        view = out.data
        out.full_min_sample += offset_a
        out.full_max_sample += offset_a
        source._render(out)
        out.full_min_sample -= offset_a
        out.full_max_sample -= offset_a
        out.current_min_sample -= offset_a
        out.current_max_sample -= offset_a
        if out.data is not view:
            rendered = np.asarray(out.data, np.float32)
            if not out.empty:
                lo = max(out.current_min_sample, out.full_min_sample)
                hi = min(out.current_max_sample, out.full_max_sample)
                if hi >= lo:
                    view[out._row(lo):out._row(hi) + 1] = \
                        _adapt_channels(rendered[out._row(lo):
                                                 out._row(hi) + 1],
                                        out.channels)
            out.data = view
        attenuate(out, mix_a)
        return

    if mix_a == 0.0:
        return

    temp = AudioFrame(out.full_min_sample + offset_a,
                      out.full_max_sample + offset_a, out.channels)
    source._render(temp)
    mix_add(out, temp, mix_a, offset_a)


# --- sources -----------------------------------------------------------------

class AudioPassThroughFilter(AudioSource):
    """Delegates to another source (src/process/AudioPassThroughFilter.c);
    source is swappable at runtime."""

    def __init__(self, source):
        self._source = source

    def set_source(self, source):
        self._source = source

    def get_source(self):
        return self._source

    def _render(self, frame):
        if self._source is None:
            frame.set_empty()
            return
        self._source._render(frame)


class AudioSequence(AudioSource):
    """Back-to-back (source, offset, length) clips addressed by sample
    (src/process/AudioSequence.c). Supports list protocol +
    insert/append + get_start_sample(i)."""

    def __init__(self, items=None):
        self._items = []
        self._starts = []
        if items:
            for item in items:
                self.append(item)

    @staticmethod
    def _check(value):
        source, offset, length = value
        if length < 0:
            raise ValueError('Length cannot be less than zero.')
        return (source, int(offset), int(length))

    def _recompute(self):
        start = 0
        self._starts = []
        for _, _, length in self._items:
            self._starts.append(start)
            start += length

    def insert(self, i, value):
        value = self._check(value)
        if i < 0:
            i += len(self._items)
        self._items.insert(max(0, min(i, len(self._items))), value)
        self._recompute()

    def append(self, value):
        self.insert(len(self._items), value)

    def get_start_sample(self, i):
        if i < 0 or i >= len(self._items):
            raise IndexError('Index was out of range.')
        return self._starts[i]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, value):
        self._items[i] = self._check(value)
        self._recompute()

    def __delitem__(self, i):
        del self._items[i]
        self._recompute()

    def _render(self, frame):
        if frame.full_max_sample < 0 or not self._items:
            frame.set_empty()
            return

        lo = max(0, frame.full_min_sample)
        frame.current_min_sample = lo
        frame.current_max_sample = lo - 1

        i = bisect.bisect_right(self._starts, lo) - 1
        i = max(0, i)

        while i < len(self._items):
            source, offset, length = self._items[i]
            start = self._starts[i]

            g_min = max(start, frame.full_min_sample, 0)
            g_max = min(start + length - 1, frame.full_max_sample)

            if g_min > frame.full_max_sample:
                break

            if g_max >= g_min:
                ghost = frame.ghost(g_min, g_max, g_min, g_max)
                if source is not None:
                    # pull in source-local samples: timeline - start + offset
                    mix_add_pull_direct(ghost, source, offset - start)
                else:
                    ghost.data[:] = 0.0
                frame.current_max_sample = g_max

            if frame.current_max_sample >= frame.full_max_sample:
                break
            i += 1


def mix_add_pull_direct(ghost, source, offset):
    """Pull *source* into *ghost* with sample numbers rebased by offset,
    overwriting (sequence fill, AudioSequence.c:83-100 + the intended
    element offset)."""
    ghost.full_min_sample += offset
    ghost.full_max_sample += offset
    ghost.current_min_sample = ghost.full_min_sample
    ghost.current_max_sample = ghost.full_max_sample
    view = ghost.data
    source._render(ghost)
    if ghost.data is not view:
        # the source ASSIGNED frame.data, severing the parent view;
        # copy its samples back through the view, window-bounded and
        # channel-adapted like mix_add_pull (a source assigning more
        # channels or fewer rows than pulled crashed the raw slice
        # assignment here)
        rendered = np.asarray(ghost.data, np.float32)
        view[:] = 0.0
        if not ghost.empty:
            lo = max(ghost.current_min_sample, ghost.full_min_sample)
            hi = min(ghost.current_max_sample, ghost.full_max_sample)
            if hi >= lo:
                view[ghost._row(lo):ghost._row(hi) + 1] = \
                    _adapt_channels(rendered[ghost._row(lo):
                                             ghost._row(hi) + 1],
                                    ghost.channels)
        ghost.data = view
    # zero anything the source didn't provide
    if ghost.empty:
        ghost.data[:] = 0.0
    else:
        lo = ghost._row(ghost.current_min_sample)
        hi = ghost._row(ghost.current_max_sample)
        ghost.data[:lo] = 0.0
        ghost.data[hi + 1:] = 0.0
    ghost.full_min_sample -= offset
    ghost.full_max_sample -= offset
    ghost.current_min_sample = ghost.full_min_sample
    ghost.current_max_sample = ghost.full_max_sample


class AudioWorkspace(_WorkspaceBase, AudioSource):
    """Sample-interval compositing workspace: overlapping items are
    mixed additively (workspace_audio_get_frame, workspace.c:615-676)."""

    def __init__(self):
        _WorkspaceBase.__init__(self)

    def _render(self, frame):
        items = self._composite_items(frame.full_min_sample,
                                      frame.full_max_sample)

        # inverted-window "empty" marker (workspace.c:623-624)
        frame.current_min_sample = frame.full_max_sample
        frame.current_max_sample = frame.full_min_sample

        if not items:
            frame.set_empty()
            return

        for item in items:
            g_full_min = max(frame.full_min_sample, item._x)
            g_full_max = min(frame.full_max_sample,
                             item._x + item._length - 1)
            if g_full_max < g_full_min:
                continue

            g_cur_min = max(frame.current_min_sample, item._x)
            g_cur_max = min(frame.current_max_sample,
                            item._x + item._length - 1)

            ghost = frame.ghost(g_full_min, g_full_max, g_cur_min, g_cur_max)
            # Composite sample i pulls source sample i - x + offset —
            # the VIDEO convention (workspace.c:530), deliberately NOT
            # the reference's audio line (workspace.c:655 rebases by
            # -(x + offset), inverting offset vs its own video path;
            # its AudioSequence stores offset and never applies it —
            # both untested there). The editor model drives A/V clips
            # with one offset semantic, so audio must match video.
            mix_add_pull(ghost, item.source, 1.0,
                         -(item._x - item._offset))

            if not ghost.empty:
                frame.current_min_sample = min(frame.current_min_sample,
                                               ghost.current_min_sample)
                frame.current_max_sample = max(frame.current_max_sample,
                                               ghost.current_max_sample)

        if frame.current_max_sample < frame.current_min_sample:
            frame.set_empty()
