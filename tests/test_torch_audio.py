"""The port's audio engine (``canvas_tpu_torch.audio``) against the JAX
package's (``canvas_tpu.audio``), on seeded frames.

Both are NumPy; every case builds the same frames and sources in each
package, runs the same helper or pull, and holds the results equal: the
full and current sample windows, the channel count and every sample
(tolerance 0).
"""

import numpy as np
import pytest

from canvas_tpu import audio as ref_audio
from canvas_tpu_torch import audio as port_audio
from canvas_tpu_torch import process


def _frame(lib, rng, channels=None, empty=False):
    """A seeded frame of *lib*: a random full range, channel count and
    current window inside it (or the empty window), and samples that
    are noise outside the current window too, as a caller may hand."""
    lo = int(rng.randint(-40, 40))
    hi = lo + int(rng.randint(0, 60))
    ch = int(rng.randint(1, 4)) if channels is None else channels
    frame = lib.AudioFrame(lo, hi, ch)
    frame.data[:] = rng.uniform(-1, 1, frame.data.shape).astype(np.float32)
    if empty:
        frame.set_empty()
    else:
        a, b = sorted(rng.randint(lo, hi + 1, 2))
        frame.current_min_sample, frame.current_max_sample = int(a), int(b)
    return frame


def _pair(seed, **kw):
    """The same seeded frame in each package."""
    return (_frame(port_audio, np.random.RandomState(seed), **kw),
            _frame(ref_audio, np.random.RandomState(seed), **kw))


def _same(got, want):
    assert (got.full_min_sample, got.full_max_sample, got.channels) == (
        want.full_min_sample, want.full_max_sample, want.channels)
    assert got.empty == want.empty
    if not want.empty:
        assert (got.current_min_sample, got.current_max_sample) == (
            want.current_min_sample, want.current_max_sample)
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))


HELPERS = {
    'copy_frame': lambda lib, out, in_, off, k: lib.copy_frame(out, in_, off),
    'copy_frame_attenuate': lambda lib, out, in_, off, k:
        lib.copy_frame_attenuate(out, in_, k, off),
    'overwrite_frame': lambda lib, out, in_, off, k:
        lib.overwrite_frame(out, in_, off),
    'attenuate': lambda lib, out, in_, off, k: lib.attenuate(out, k),
    'mix_add': lambda lib, out, in_, off, k: lib.mix_add(out, in_, k, off),
    'mix_add_pull': lambda lib, out, in_, off, k:
        lib.mix_add_pull(out, in_, k, off),
}


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('name', sorted(HELPERS))
def test_helpers_match_jax(name, seed):
    """Each helper over frames with overlapping, disjoint and empty
    windows, channel counts that differ, offsets and factors 0, 1 and
    others."""
    rng = np.random.RandomState(100 + seed)
    for case in range(8):
        out_empty, in_empty = case == 3, case == 5
        p_out, r_out = _pair(1000 * seed + 2 * case, empty=out_empty)
        p_in, r_in = _pair(1000 * seed + 2 * case + 1, empty=in_empty)
        offset = int(rng.randint(-30, 30))
        factor = float(rng.choice([0.0, 1.0, 0.5, -1.25]))
        HELPERS[name](port_audio, p_out, p_in, offset, factor)
        HELPERS[name](ref_audio, r_out, r_in, offset, factor)
        _same(p_out, r_out)
        _same(p_in, r_in)


class _Tone:
    """A source of *lib* made as a class of that package: a seeded
    waveform over [lo, hi] with *ch* channels; ``assign`` sets
    ``frame.data`` to a new array (with another channel count) instead
    of writing in place, the case the ghost views copy back."""

    @staticmethod
    def make(lib, seed, lo, hi, ch, assign=False):
        wave = np.random.RandomState(seed).uniform(
            -1, 1, (hi - lo + 1, 4)).astype(np.float32)

        class Tone(lib.AudioSource):
            def _render(self, frame):
                a = max(frame.full_min_sample, lo)
                b = min(frame.full_max_sample, hi)
                if b < a:
                    frame.set_empty()
                    return
                if assign:
                    data = np.zeros((len(frame), ch + 1), np.float32)
                    data[a - frame.full_min_sample:
                         b - frame.full_min_sample + 1] = \
                        wave[a - lo:b - lo + 1, :ch + 1]
                    frame.data = data
                else:
                    frame.data[:] = 0.0
                    frame.data[a - frame.full_min_sample:
                               b - frame.full_min_sample + 1] = \
                        wave[a - lo:b - lo + 1, :frame.channels]
                frame.current_min_sample = a
                frame.current_max_sample = b

        return Tone()


def _sequence(lib, assign):
    return lib.AudioSequence([
        (_Tone.make(lib, 1, 0, 300, 2, assign), 5, 40),
        (None, 0, 10),
        (_Tone.make(lib, 2, -50, 50, 1, assign), -20, 30),
        (lib.AudioFrame(0, 49, 2, data=np.linspace(
            -1, 1, 100, dtype=np.float32)), 3, 25),
    ])


def _workspace(lib, assign):
    ws = lib.AudioWorkspace()
    ws.add(source=_Tone.make(lib, 3, 0, 500, 2, assign), x=10, length=80,
           offset=4, z=0)
    ws.add(source=_Tone.make(lib, 4, -100, 100, 3, assign), x=60,
           length=50, offset=-30, z=1)
    ws.add(source=_sequence(lib, assign), x=-20, length=120, offset=7, z=2)
    return ws


SOURCES = {
    'pass_through': lambda lib, assign: lib.AudioPassThroughFilter(
        _Tone.make(lib, 5, -10, 90, 2, assign)),
    'pass_through_none': lambda lib, assign: lib.AudioPassThroughFilter(None),
    'frame': lambda lib, assign: lib.AudioFrame(
        -5, 44, 2, data=np.random.RandomState(6).uniform(
            -1, 1, (50, 2)).astype(np.float32)),
    'sequence': _sequence,
    'workspace': _workspace,
}


@pytest.mark.parametrize('assign', [False, True])
@pytest.mark.parametrize('name', sorted(SOURCES))
def test_sources_match_jax(name, assign):
    """Pulls over ranges before, across and past each source's samples,
    at 1, 2 and 3 channels."""
    got, want = SOURCES[name](port_audio, assign), SOURCES[name](ref_audio,
                                                                 assign)
    for lo, hi, ch in ((-60, -30, 2), (-25, 40, 1), (0, 119, 2),
                       (30, 200, 3), (95, 400, 2), (5, 5, 1)):
        _same(got.get_frame(lo, hi, ch), want.get_frame(lo, hi, ch))


def test_frame_protocol_matches_jax():
    """``sample``, indexing, ``ghost``, ``repr`` and the argument checks."""
    got, want = _pair(77, channels=2)
    for s in range(got.full_min_sample - 2, got.full_max_sample + 3):
        for c in (0, 1):
            assert got.sample(s, c) == want.sample(s, c)
    assert len(got) == len(want)
    assert [got[i] for i in range(len(got))] == [
        want[i] for i in range(len(want))]
    assert repr(got) == repr(want)
    g = got.ghost(got.full_min_sample + 1, got.full_max_sample - 1,
                  got.full_min_sample + 2, got.full_max_sample - 2)
    w = want.ghost(want.full_min_sample + 1, want.full_max_sample - 1,
                   want.full_min_sample + 2, want.full_max_sample - 2)
    _same(g, w)
    g.data[:] = 3.0
    assert np.shares_memory(g.data, got.data)
    for lib in (port_audio, ref_audio):
        with pytest.raises(ValueError, match='max_sample'):
            lib.AudioFrame(5, 4, 1)
        with pytest.raises(ValueError, match='channels'):
            lib.AudioFrame(0, 4, -1)
        with pytest.raises(IndexError):
            lib.AudioFrame(0, 4, 1, data=np.zeros(5)).sample(0, 2)
        with pytest.raises(ValueError, match='Length'):
            lib.AudioSequence([(None, 0, -1)])


def test_sequence_list_protocol_matches_jax():
    seqs = [_sequence(lib, False) for lib in (port_audio, ref_audio)]
    for seq in seqs:
        seq.insert(-1, (None, 2, 7))
        seq[0] = (seq[0][0], 1, 33)
        del seq[2]
        seq.append((None, 0, 4))
    got, want = seqs
    assert len(got) == len(want)
    assert ([got.get_start_sample(i) for i in range(len(got))]
            == [want.get_start_sample(i) for i in range(len(want))])
    assert [it[1:] for it in got] == [it[1:] for it in want]
    _same(got.get_frame(-3, 90, 2), want.get_frame(-3, 90, 2))


def test_process_exports_audio():
    """``process`` exports the audio surface the JAX package's does."""
    for name in ('AudioFrame', 'AudioSource', 'AudioPassThroughFilter',
                 'AudioSequence', 'AudioWorkspace'):
        assert getattr(process, name) is getattr(port_audio, name)
    assert process.AudioWorkspaceItem is process.WorkspaceItem
    ws = process.AudioWorkspace()
    item = ws.add(source=None, x=0, length=4)
    assert isinstance(item, process.AudioWorkspaceItem)
