"""The port's audio output (``canvas_tpu_torch.audioout``: sinks and the
``AudioPlayer`` that is the presentation clock) against the JAX
package's (``canvas_tpu.audioout``). Both are host code over NumPy.

The cases are ports of tests/test_encoders.py's audio player tests
(145-370), each run on both packages with the results compared:

- a capturing sink records what each player writes for the same ramp
  source (sample s has value s) at speeds 1, 2, 1/2 and -1: the first
  8 chunks are equal between the packages, sample for sample
  (tolerance 0), and equal to the decimation AlsaPlayer.c:160-180
  describes;
- ``WavFileSink``: the same chunks written through each give
  byte-equal files;
- the clock follows the consumed samples: with a sink that consumes
  a fixed number of chunks and then blocks, each player's clock stands
  at ``time(next_sample) - time(delay) * speed``, the same in both;
- ``NullSink`` paces in real time, a bare callable works as a sink,
  ``AlsaSink`` is gated the same in both, and ``close()`` joins the
  audio thread before it closes the sink.

Every wait has a deadline of at most 10 s.
"""

import math
import threading
import time
from fractions import Fraction

import numpy as np
import pytest

from canvas_tpu import audio as ref_audio
from canvas_tpu import audioout as ref_out
from canvas_tpu_torch import audio as port_audio
from canvas_tpu_torch import audioout as port_out

DEADLINE = 10.0
PACKAGES = [(port_out, port_audio), (ref_out, ref_audio)]


def _wait(cond, budget=DEADLINE):
    deadline = time.time() + budget
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


def _ramp(audio_mod):
    """An audio source of *audio_mod* whose sample s has value s."""
    class Ramp:
        def get_frame(self, min_sample, max_sample, channels):
            n = max_sample - min_sample + 1
            data = np.repeat(np.arange(min_sample, max_sample + 1,
                                       dtype=np.float32)[:, None],
                             channels, 1)
            return audio_mod.AudioFrame(min_sample, max_sample, channels,
                                        data)
    return Ramp()


def _tone(audio_mod):
    class Tone(audio_mod.AudioSource):
        def _render(self, frame):
            t = np.arange(frame.full_min_sample,
                          frame.full_max_sample + 1) / 48000.0
            tone = 0.5 * np.sin(2 * math.pi * 440 * t)
            frame.data = np.repeat(tone[:, None], frame.channels,
                                   axis=1).astype(np.float32)
            frame.current_min_sample = frame.full_min_sample
            frame.current_max_sample = frame.full_max_sample
    return Tone()


class CaptureSink:
    """Unpaced sink recording every chunk; after *limit* chunks it
    consumes nothing more (the player then waits on it), so what it
    holds does not depend on how fast the thread ran."""

    def __init__(self, limit=None, delay=0):
        self.chunks = []
        self.drops = 0
        self.limit = limit
        self._delay = delay
        self.full = threading.Event()
        self.closed_with_thread_alive = None
        self.player = None

    def write(self, samples):
        if self.limit is not None and len(self.chunks) >= self.limit:
            self.full.set()
            return 0
        self.chunks.append(np.array(samples, copy=True))
        return len(samples)

    def delay(self):
        return self._delay

    def drop(self):
        self.drops += 1

    def close(self):
        if self.player is not None:
            self.closed_with_thread_alive = self.player._thread.is_alive()


def _play(out_mod, audio_mod, speed, chunks, seek_sample=None, channels=2,
          chunk_frames=256, delay=0):
    """The first *chunks* chunks a player of *out_mod* writes for the
    ramp at *speed* (after a seek to *seek_sample*), and the player's
    clock state once the sink blocks."""
    sink = CaptureSink(limit=chunks, delay=delay)
    player = out_mod.AudioPlayer(48000, channels, _ramp(audio_mod),
                                 sink=sink, chunk_frames=chunk_frames)
    sink.player = player
    try:
        if seek_sample is not None:
            player.seek((seek_sample * 1_000_000_000) // 48000 + 1)
        player.play(speed)
        assert sink.full.wait(DEADLINE), len(sink.chunks)
        with player._mutex:
            state = (player._seek_time, player._next_sample, player._speed)
    finally:
        player.close()
    assert sink.closed_with_thread_alive is False
    return sink.chunks, state


def _expected(speed, chunk_frames, chunks, start):
    """The decimated ramp AlsaPlayer.c:160-180 writes: per chunk,
    sw = B*|n|/d source samples in, hw = B*d/|n| device samples out,
    output index i reads source sample i*|n|/d of the chunk; negative
    speeds read backwards and reverse the chunk."""
    n, d = speed.numerator, speed.denominator
    B = chunk_frames
    sw = min(B, B * abs(n) // d) or 1
    hw = min(B, B * d // abs(n)) or 1
    out = []
    nxt = start
    for _ in range(chunks):
        lo = nxt if n > 0 else nxt - sw + 1
        src = np.arange(lo, lo + sw, dtype=np.float32)
        idx = np.minimum((np.arange(hw) * abs(n)) // d, sw - 1)
        got = src[idx]
        out.append(got if n > 0 else got[::-1])
        nxt += sw if n > 0 else -sw
    return out


@pytest.mark.parametrize('speed, seek', [
    (Fraction(1), None), (Fraction(2), None), (Fraction(1, 2), None),
    (Fraction(-1), 1000)])
def test_player_samples_equal_at_speeds(speed, seek):
    """The first 8 chunks each player writes for the ramp are equal
    between the packages (tolerance 0) and are the reference's
    decimation of the ramp."""
    results = [_play(out_mod, audio_mod, speed, 8, seek_sample=seek)
               for out_mod, audio_mod in PACKAGES]
    (got, got_state), (want, want_state) = results
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g[:, 0], g[:, 1])
    start = 0 if seek is None else (
        ((seek * 1_000_000_000) // 48000 + 1) * 48000) // 1_000_000_000
    for g, e in zip(got, _expected(speed, 256, 8, start)):
        np.testing.assert_array_equal(g[:, 0], e)
    assert got_state == want_state


def test_clock_follows_consumed_samples():
    """After the sink took 5 chunks of 256 and reports 300 frames
    still queued, each player's clock stands at time(next sample)
    minus time(queued) at the speed, in both packages alike."""
    states = [_play(out_mod, audio_mod, Fraction(1), 5, delay=300)[1]
              for out_mod, audio_mod in PACKAGES]
    assert states[0] == states[1]
    seek_time, next_sample, speed = states[0]
    assert next_sample in (5 * 256, 6 * 256)   # the 6th chunk is pulled

    def t(sample):
        return (sample * 1_000_000_000) // 48000

    assert seek_time == t(5 * 256) - t(300)


def test_wav_file_sink_byte_equal(tmp_path):
    """The same chunks written through each package's WavFileSink make
    byte-equal float32 WAV files with the reference's header."""
    rng = np.random.default_rng(20261017)
    chunks = [rng.uniform(-1, 1, (int(k), 2)).astype(np.float32)
              for k in rng.integers(1, 700, 6)]
    paths = []
    for out_mod, _audio in PACKAGES:
        path = str(tmp_path / ('%s.wav' % out_mod.__name__))
        sink = out_mod.WavFileSink(path, 8000, 2)
        for c in chunks:
            assert sink.write(c) == len(c)
        assert (sink.delay(), sink.drop()) == (0, None)
        sink.close()
        paths.append(path)
    got, want = (open(p, 'rb').read() for p in paths)
    assert got == want
    assert got[:4] == b'RIFF' and got[8:12] == b'WAVE'
    import struct
    assert struct.unpack('<HHI', got[20:28]) == (3, 2, 8000)
    assert len(got) == 44 + 4 * 2 * sum(len(c) for c in chunks)


def test_wav_file_sink_through_player(tmp_path):
    """A player writing the ramp into each package's WavFileSink: the
    samples both files hold agree where both have them, and are the
    ramp (the tests/test_encoders.py case, compared)."""
    datas = []
    for out_mod, audio_mod in PACKAGES:
        path = str(tmp_path / ('%s.wav' % out_mod.__name__))
        sink = out_mod.WavFileSink(path, 8000, 2)
        player = out_mod.AudioPlayer(8000, 2, _ramp(audio_mod), sink=sink,
                                     chunk_frames=512)
        try:
            player.play(1)
            assert _wait(lambda: sink._frames >= 2048)
            player.stop()
        finally:
            player.close()
        with open(path, 'rb') as f:
            data = f.read()
        datas.append(np.frombuffer(data[44:], np.float32).reshape(-1, 2))
    n = min(len(d) for d in datas)
    assert n >= 2048
    np.testing.assert_array_equal(datas[0][:n], datas[1][:n])
    np.testing.assert_array_equal(datas[0][:n, 0],
                                  np.arange(n, dtype=np.float32))


def test_player_clock_callable_sink_and_speeds():
    """tests/test_encoders.py's test_audio_player_clock on both
    packages: a bare callable sink, play/stop/negative speed move the
    clock alike (time ranges, not values: the callable sink is paced
    in real time)."""
    for out_mod, audio_mod in PACKAGES:
        consumed = []
        player = out_mod.AudioPlayer(8000, 1, _tone(audio_mod),
                                     sink=lambda d: consumed.append(len(d)))
        try:
            assert player.get_presentation_time() == 0
            player.play(1)
            assert _wait(lambda: player.get_presentation_time()
                         > 100_000_000)
            assert consumed
            player.stop()
            frozen = player.get_presentation_time()
            time.sleep(0.05)
            assert player.get_presentation_time() == frozen
            player.play(Fraction(-1, 1))
            assert _wait(lambda: player.get_presentation_time() < frozen)
            assert player.get_speed() == -1
        finally:
            player.close()


def test_null_sink_paces_in_real_time():
    """NullSink consumes at its rate once its buffer is full, in both
    packages: over ~0.3 s at 8000 Hz, about 2400 frames beyond its
    4096-frame buffer."""
    for out_mod, _audio in PACKAGES:
        sink = out_mod.NullSink(8000, buffer_frames=4096)
        block = np.zeros((512, 2), np.float32)
        t0 = time.monotonic()
        taken = 0
        while time.monotonic() - t0 < 0.3:
            taken += sink.write(block)
        elapsed = time.monotonic() - t0
        assert 4096 <= taken <= 4096 + 8000 * elapsed + 1024
        assert 0 <= sink.delay() <= 4096
        sink.drop()
        assert sink.delay() == 0


def test_alsa_sink_gated_alike():
    assert port_out.alsa_available() == ref_out.alsa_available()
    for out_mod, _audio in PACKAGES:
        if not out_mod.alsa_available():
            with pytest.raises(RuntimeError):
                out_mod.AlsaSink(48000, 2)
    assert port_out.AlsaPlayer is port_out.AudioPlayer


def test_close_joins_the_thread_before_the_sink():
    """close() joins the audio thread first and closes the sink after
    (AlsaPlayer's teardown order: a freed device handle must never
    reach a write)."""
    for out_mod, audio_mod in PACKAGES:
        sink = CaptureSink()
        player = out_mod.AudioPlayer(48000, 2, _ramp(audio_mod), sink=sink,
                                     chunk_frames=64)
        sink.player = player
        player.play(1)
        assert _wait(lambda: len(sink.chunks) >= 2)
        player.close()
        assert sink.closed_with_thread_alive is False
        assert not player._thread.is_alive()
