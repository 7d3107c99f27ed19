"""Audio output: a playback thread that doubles as the presentation clock
(the port's copy of ``canvas_tpu/audioout.py``; host code only, NumPy).

Equivalent of the reference's alsa module
(src/alsa/AlsaPlayer.c): AlsaPlayer runs its own thread
pulling ``audio_get_frame`` (:56-111) and *is* the presentation clock for
the rest of the pipeline (vtable :605-610), supporting variable and
negative speeds.

Design mirrors the reference loop:

* Speed conversion (AlsaPlayer.c:160-180): per chunk the thread pulls
  ``swCount = B*|n|/d`` source samples and writes ``hwCount = B*d/|n|``
  device samples by index decimation ``i*n/d``; negative speeds reverse
  the output order.
* The clock is SAMPLE-driven, not wall-driven (AlsaPlayer.c:218-228):
  after each write ``seek_time = time(next_sample) - time(delay)*speed``
  where ``delay`` is how many frames the sink still has queued — so
  video follows what was actually *heard*.
* Seeks/stops drop the sink's queue (snd_pcm_drop, :63-65).

Sinks implement ``write(samples) -> frames_consumed`` (may be partial,
like snd_pcm_writei), plus optional ``delay() -> queued_frames``,
``drop()`` and ``close()``. Provided: :class:`NullSink` (real-time
pacing, the CI/headless device), :class:`WavFileSink` (offline export),
and :class:`AlsaSink` (ctypes over libasound, gated on availability).
A bare callable also works as a sink (consumes everything, no delay).
"""

import ctypes
import ctypes.util
import struct
import threading
import time
from fractions import Fraction

import numpy as np

from canvas_tpu_torch.clock import PresentationClock, gettime

__all__ = ['AudioPlayer', 'AlsaPlayer', 'NullSink', 'WavFileSink', 'AlsaSink',
           'alsa_available']


class NullSink:
    """Emulates a real audio device for headless playback: writes block
    when the virtual device buffer is full (the pacing snd_pcm_writei
    provides), so the player thread runs at real time."""

    def __init__(self, rate, buffer_frames=4096):
        self.rate = int(rate)
        self.buffer_frames = int(buffer_frames)
        self._queued = 0.0          # frames queued at _last_time
        self._last_time = time.monotonic()

    def _drain(self):
        now = time.monotonic()
        played = (now - self._last_time) * self.rate
        self._queued = max(0.0, self._queued - played)
        self._last_time = now

    def write(self, samples):
        self._drain()
        if self._queued >= self.buffer_frames:
            # block until half the buffer drains (device back-pressure)
            time.sleep((self._queued - self.buffer_frames / 2) / self.rate)
            self._drain()
        room = int(self.buffer_frames - self._queued)
        n = min(len(samples), max(room, 1))
        self._queued += n
        return n

    def delay(self):
        self._drain()
        return int(self._queued)

    def drop(self):
        self._queued = 0.0
        self._last_time = time.monotonic()

    def close(self):
        pass


class WavFileSink:
    """Writes float32 WAV (format 3); no pacing — offline export/test
    sink. Sample-accurate: every frame written lands in the file."""

    def __init__(self, path, rate, channels):
        self.rate = int(rate)
        self.channels = int(channels)
        self._f = open(path, 'wb')
        self._frames = 0
        self._write_header(0)

    def _write_header(self, data_bytes):
        f = self._f
        f.seek(0)
        block = 4 * self.channels
        f.write(b'RIFF')
        f.write(struct.pack('<I', 36 + data_bytes))
        f.write(b'WAVEfmt ')
        f.write(struct.pack('<IHHIIHH', 16, 3, self.channels, self.rate,
                            self.rate * block, block, 32))
        f.write(b'data')
        f.write(struct.pack('<I', data_bytes))

    def write(self, samples):
        samples = np.ascontiguousarray(samples, np.float32)
        self._f.write(samples.tobytes())
        self._frames += len(samples)
        return len(samples)

    def delay(self):
        return 0

    def drop(self):
        pass

    def close(self):
        self._write_header(self._frames * 4 * self.channels)
        self._f.close()


_alsa = None


def _load_alsa():
    global _alsa
    if _alsa is None:
        path = ctypes.util.find_library('asound')
        _alsa = ctypes.CDLL(path) if path else False
        if _alsa:
            # snd_pcm_writei/snd_pcm_delay return snd_pcm_sframes_t (a
            # long); ctypes' default c_int restype truncates on LP64.
            _alsa.snd_pcm_open.restype = ctypes.c_int
            _alsa.snd_pcm_set_params.restype = ctypes.c_int
            _alsa.snd_pcm_writei.restype = ctypes.c_long
            _alsa.snd_pcm_delay.restype = ctypes.c_int
            _alsa.snd_pcm_recover.restype = ctypes.c_int
            _alsa.snd_pcm_drop.restype = ctypes.c_int
            _alsa.snd_pcm_prepare.restype = ctypes.c_int
            _alsa.snd_pcm_close.restype = ctypes.c_int
    return _alsa


def alsa_available():
    return bool(_load_alsa())


class AlsaSink:
    """Real ALSA PCM device sink via ctypes (snd_pcm_* -
    AlsaPlayer.c:390-460). Gated: raises RuntimeError when libasound is
    not present (the code activates on hosts that have it)."""

    SND_PCM_STREAM_PLAYBACK = 0
    SND_PCM_FORMAT_FLOAT_LE = 14
    SND_PCM_ACCESS_RW_INTERLEAVED = 3

    def __init__(self, rate, channels, device='default'):
        lib = _load_alsa()
        if not lib:
            raise RuntimeError('libasound not available')
        self._lib = lib
        self.rate = int(rate)
        self.channels = int(channels)
        self._pcm = ctypes.c_void_p()
        rc = lib.snd_pcm_open(ctypes.byref(self._pcm),
                              device.encode(), self.SND_PCM_STREAM_PLAYBACK,
                              0)
        if rc < 0:
            raise IOError('snd_pcm_open failed: %d' % rc)
        rc = lib.snd_pcm_set_params(
            self._pcm, self.SND_PCM_FORMAT_FLOAT_LE,
            self.SND_PCM_ACCESS_RW_INTERLEAVED, self.channels, self.rate,
            1, 100000)   # allow resample, 100 ms latency
        if rc < 0:
            raise IOError('snd_pcm_set_params failed: %d' % rc)

    def write(self, samples):
        samples = np.ascontiguousarray(samples, np.float32)
        rc = self._lib.snd_pcm_writei(
            self._pcm, samples.ctypes.data_as(ctypes.c_void_p),
            len(samples))
        if rc == -11:          # EAGAIN
            return 0
        if rc < 0:             # underrun etc: recover like the reference
            self._lib.snd_pcm_recover(self._pcm, rc, 1)
            return 0
        return rc

    def delay(self):
        d = ctypes.c_long()
        if self._lib.snd_pcm_delay(self._pcm, ctypes.byref(d)) < 0:
            return 0
        return max(0, d.value)

    def drop(self):
        self._lib.snd_pcm_drop(self._pcm)
        self._lib.snd_pcm_prepare(self._pcm)

    def close(self):
        self._lib.snd_pcm_close(self._pcm)


class _CallableSink(NullSink):
    """Bare-callable sink: paced like the null device so headless
    playback still runs at real time."""

    def __init__(self, fn, rate):
        NullSink.__init__(self, rate)
        self._fn = fn

    def write(self, samples):
        n = NullSink.write(self, samples)
        self._fn(samples[:n])
        return n


class AudioPlayer(PresentationClock):
    """Audio sink + presentation clock (AlsaPlayer.c:349-351 signature:
    (rate, channels, source))."""

    def __init__(self, rate, channels, source=None, sink=None,
                 chunk_frames=1024):
        PresentationClock.__init__(self)
        self.rate = int(rate)
        self.channels = int(channels)
        self.source = source
        if sink is None:
            sink = NullSink(rate)
        elif callable(sink) and not hasattr(sink, 'write'):
            sink = _CallableSink(sink, rate)
        self.sink = sink
        self.chunk_frames = int(chunk_frames)

        self._mutex = threading.Lock()
        self._seek_time = 0
        self._base_time = gettime()
        self._speed = Fraction(0, 1)
        self._time_change = False
        self._next_sample = 0
        self._quit = False
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='canvas-audio')
        self._thread.start()

    def set_audio_source(self, source):
        self.source = source

    # -- clock interface ---------------------------------------------------

    def get_presentation_time(self):
        with self._mutex:
            return self._presentation_time_locked()

    def _presentation_time_locked(self):
        if self._speed.numerator == 0:
            return self._seek_time
        elapsed = (gettime() - self._base_time) * self._speed.numerator
        if self._speed.denominator != 1:
            elapsed //= self._speed.denominator
        return self._seek_time + elapsed

    def get_speed(self):
        with self._mutex:
            return self._speed

    def _sample_time(self, sample):
        return (int(sample) * 1_000_000_000) // self.rate

    def _set(self, seek_time, speed):
        with self._mutex:
            self._base_time = gettime()
            self._seek_time = int(seek_time)
            self._speed = Fraction(speed)
            self._next_sample = (self._seek_time * self.rate) \
                // 1_000_000_000
            self._time_change = True
        self._notify(self._speed, self._seek_time)
        self._wake.set()

    def set(self, speed, time_ns):
        self._set(time_ns, speed)

    def play(self, rate):
        self._set(self.get_presentation_time(), rate)

    def seek(self, time_ns):
        self._set(time_ns, self._speed)

    def stop(self):
        self._set(self.get_presentation_time(), Fraction(0, 1))

    def close(self):
        self._quit = True
        self._wake.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # thread stuck in a slow decode/back-pressure sleep:
            # closing the sink under it would hand a freed ALSA handle
            # to its next write (libasound UB); leak instead
            import logging
            logging.getLogger('canvas_tpu_torch.audioout').warning(
                'audio thread did not exit; leaving sink open')
            return
        self.sink.close()

    # -- playback thread (AlsaPlayer.c:56-233) -----------------------------

    def _run(self):
        B = self.chunk_frames
        while not self._quit:
            with self._mutex:
                speed = self._speed
                if self._time_change:
                    self._time_change = False
                    self.sink.drop()
            if speed == 0 or self.source is None:
                self._wake.wait(0.1)
                self._wake.clear()
                continue

            n, d = speed.numerator, speed.denominator
            # swCount source samples in, hwCount device samples out
            sw = min(B, B * abs(n) // d) or 1
            hw = min(B, B * d // abs(n)) or 1

            with self._mutex:
                next_sample = self._next_sample
                if n > 0:
                    lo, hi = next_sample, next_sample + sw - 1
                    self._next_sample += sw
                else:
                    lo, hi = next_sample - sw + 1, next_sample
                    self._next_sample -= sw

            frame = self.source.get_frame(lo, hi, self.channels)
            data = np.asarray(frame.data, np.float32)
            # Zero anything outside the provided window (AlsaPlayer.c:117-156)
            if frame.current_max_sample < frame.current_min_sample:
                data = np.zeros((sw, self.channels), np.float32)
            else:
                pre = frame.current_min_sample - frame.full_min_sample
                post = frame.full_max_sample - frame.current_max_sample
                if pre > 0 or post > 0:
                    data = np.array(data, copy=True)   # don't zero the
                    if pre > 0:                        # source's buffer
                        data[:pre] = 0.0
                    if post > 0:
                        data[len(data) - post:] = 0.0

            # Speed conversion by decimation (AlsaPlayer.c:160-180)
            if n == 1 and d == 1:
                out = data
            elif n > 0:
                idx = (np.arange(hw) * n) // d
                out = data[np.minimum(idx, len(data) - 1)]
            else:
                idx = (np.arange(hw) * -n) // d
                out = data[np.minimum(idx, len(data) - 1)][::-1]

            # Write, honoring partial consumption (snd_pcm_writei loop)
            written = 0
            while written < len(out) and not self._quit:
                with self._mutex:
                    if self._time_change or self._speed != speed:
                        break
                consumed = self.sink.write(out[written:])
                if consumed <= 0:
                    time.sleep(0.001)
                    continue
                written += consumed

            # Sample-driven clock update (AlsaPlayer.c:218-228)
            delay = self.sink.delay()
            with self._mutex:
                if not self._time_change and self._speed == speed:
                    self._base_time = gettime()
                    self._seek_time = self._sample_time(self._next_sample) \
                        - (self._sample_time(delay) * n) // d


# Reference-name alias (fluggo.media.alsa.AlsaPlayer, src/alsa/AlsaPlayer.c:
# same (rate, channels, source) constructor; our AudioPlayer defaults to a
# NullSink unless an AlsaSink/WavFileSink is passed).
AlsaPlayer = AudioPlayer
