"""The port's media IO (``canvas_tpu_torch.libav`` over its own build of
``native/canvas_av.cpp``) against the JAX package's, on the CPU, with the
pure-Python modules that ride on it (``matroska``, ``timecode``,
``formats``).

Files are written by the muxers themselves (no fixtures). With
``CANVAS_AV_THREADS=1`` the encoders are deterministic, so everything is
held equal, tolerance 0: stream and container info, demuxed packets
byte for byte, decoded planes and RGBA, decoded audio samples, the
Matroska writer's bytes, timecode strings and probed formats.
"""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from canvas_tpu import formats as ref_formats
from canvas_tpu import libav as ref_libav
from canvas_tpu import matroska as ref_mkv
from canvas_tpu import timecode as ref_timecode
from canvas_tpu_torch import audio as port_audio
from canvas_tpu_torch import formats, libav, libdv, matroska, timecode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_codec_thread(monkeypatch):
    monkeypatch.setenv('CANVAS_AV_THREADS', '1')


def _write_sample(lib, path, frames=25):
    """The 64x48 mpeg4 + 8 kHz pcm file of tests/test_libav.py, written
    by *lib*'s AVMuxer."""
    with lib.AVMuxer(path) as mux:
        v = mux.add_video_stream('mpeg4', (64, 48), 25, bit_rate=400_000)
        a = mux.add_audio_stream('pcm_s16le', 8000, 1)
        mux.start()
        for i in range(frames):
            frame = np.zeros((48, 64, 4), np.uint8)
            frame[:, :, 0] = min(255, i * 10)
            frame[:, :, 1] = np.arange(64, dtype=np.uint8)[None, :] * 3
            frame[:, :, 3] = 255
            mux.write_video_frame(v, frame)
        t = np.arange(8000, dtype=np.float32) / 8000.0
        tone = (0.5 * np.sin(2 * math.pi * 440 * t)).astype(np.float32)
        mux.write_audio_frame(a, tone.reshape(-1, 1))
    return path


@pytest.fixture(scope='module')
def sample(tmp_path_factory):
    os.environ['CANVAS_AV_THREADS'] = '1'
    try:
        return _write_sample(libav, str(
            tmp_path_factory.mktemp('media') / 'sample.avi'))
    finally:
        del os.environ['CANVAS_AV_THREADS']


def _packets(lib, path, stream):
    demux = lib.AVDemuxer(path, stream)
    out = []
    while True:
        pkt = demux.get_next_packet()
        if pkt is None:
            break
        out.append((pkt.data, pkt.pts, pkt.dts, pkt.duration, pkt.keyframe,
                    pkt.stream))
    demux.close()
    return out


# --- the library ----------------------------------------------------------

def test_library_is_the_ports_own_build():
    """Built under canvas_tpu_torch/_build/native/<hash>/, loaded from
    there, never from canvas_tpu/_native/; a handle of its own beside
    the JAX package's."""
    lib = libav._load()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(libav._library_path())
    build = os.path.realpath(os.path.join(REPO, 'canvas_tpu_torch', '_build',
                                          'native'))
    assert os.path.dirname(os.path.dirname(path)) == build
    assert 'canvas_tpu' + os.sep + '_native' not in path
    assert b'canvas_av' in lib.cav_version()
    ref = ref_libav._load()
    assert ref is not lib and os.path.realpath(ref._name) != path


def test_library_path_follows_the_sources(tmp_path, monkeypatch):
    """The hash in the path covers canvas_av.cpp and the Makefile."""
    src = tmp_path / 'native'
    src.mkdir()
    for name in ('canvas_av.cpp', 'Makefile'):
        (src / name).write_bytes(
            open(os.path.join(REPO, 'native', name), 'rb').read())
    monkeypatch.setattr(libav, '_NATIVE_SRC', str(src))
    same = libav._library_path()
    assert os.path.basename(os.path.dirname(same)) == os.path.basename(
        os.path.dirname(os.path.realpath(libav._load()._name)))
    (src / 'Makefile').write_text((src / 'Makefile').read_text() + '\n')
    assert libav._library_path() != same


def test_build_failure_raises_with_makes_output(tmp_path, monkeypatch):
    src = tmp_path / 'native'
    src.mkdir()
    (src / 'Makefile').write_bytes(
        open(os.path.join(REPO, 'native', 'Makefile'), 'rb').read())
    (src / 'canvas_av.cpp').write_text('#error deliberately broken\n')
    monkeypatch.setattr(libav, '_NATIVE_SRC', str(src))
    monkeypatch.setattr(libav, '_BUILD_ROOT', str(tmp_path / 'build'))
    monkeypatch.setattr(libav, '_lib', None)
    with pytest.raises(RuntimeError, match='deliberately broken'):
        libav._load()
    assert libav._lib is None
    assert os.listdir(tmp_path / 'build') == []      # no half-built dir


def test_concurrent_builds_end_with_one_library(tmp_path):
    """Three processes that build into one empty directory at once: each
    loads a whole library, and one library is left, with no work
    directory beside it."""
    root = tmp_path / 'build'
    script = textwrap.dedent('''
        import sys
        sys.path.insert(0, %r)
        from canvas_tpu_torch import libav
        libav._BUILD_ROOT = %r
        lib = libav._load()
        print(lib._name, lib.cav_version().decode())
    ''' % (REPO, str(root)))
    procs = [subprocess.Popen([sys.executable, '-c', script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert 'canvas_av' in out
    (digest,) = os.listdir(root)
    assert os.listdir(root / digest) == ['libcanvas_av.so']
    assert {out.split()[0] for out, _err in outs} == {
        str(root / digest / 'libcanvas_av.so')}


# --- the readers and decoders --------------------------------------------

def _info(s):
    return {k: v for k, v in vars(s).items()}


def test_container_info_matches_jax(sample):
    got, want = libav.AVContainer(sample), ref_libav.AVContainer(sample)
    for key in ('format_name', 'format_long_name', 'mime_type', 'duration',
                'bit_rate'):
        assert getattr(got, key) == getattr(want, key), key
    assert [_info(s) for s in got.streams] == [_info(s)
                                               for s in want.streams]
    assert sorted(s.type for s in got.streams) == ['audio', 'video']
    got.close()
    want.close()


@pytest.mark.parametrize('stream', [0, 1])
def test_demuxed_packets_match_jax(sample, stream):
    got = _packets(libav, sample, stream)
    assert len(got) > 0
    assert got == _packets(ref_libav, sample, stream)
    demux = libav.AVDemuxer(sample, stream)
    first = demux.get_next_packet()
    demux.get_next_packet()
    demux.seek(0)
    again = demux.get_next_packet()
    assert (again.data, again.pts) == (first.data, first.pts)
    demux.close()


def test_video_decoder_matches_jax(sample):
    got, want = libav.AVVideoDecoder(sample), ref_libav.AVVideoDecoder(sample)
    assert got.color_info() == want.color_info()
    for f in (0, 1, 7, 24, 3):
        a, b = got.get_frame(f), want.get_frame(f)
        assert len(a.planes) == len(b.planes) == 3
        for p, q in zip(a.planes, b.planes):
            assert p.dtype == np.uint8 and p.shape == q.shape
            np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(got.get_frame_rgba(f, 64, 48),
                                      want.get_frame_rgba(f, 64, 48))
    assert got.get_frame(25) is None and want.get_frame(25) is None
    assert got.get_frame(0).planes[0].shape == (48, 64)
    got.close()
    want.close()


def test_decoder_takes_a_demuxer(sample):
    video = next(i for i, s in enumerate(libav.AVContainer(sample).streams)
                 if s.type == 'video')
    a = libav.AVVideoDecoder(libav.AVDemuxer(sample, video)).get_frame(5)
    b = libav.AVVideoDecoder(sample).get_frame(5)
    for p, q in zip(a.planes, b.planes):
        np.testing.assert_array_equal(p, q)
    # the DV decoder is the same decoder under the reference's name
    c = libdv.DVVideoDecoder(sample).get_frame(5)
    np.testing.assert_array_equal(c.planes[0], b.planes[0])


@pytest.mark.parametrize('channels', [1, 2])
def test_audio_decoder_matches_jax(sample, channels):
    got = libav.AVAudioDecoder(sample, channels=channels)
    want = ref_libav.AVAudioDecoder(sample, channels=channels)
    assert (got.channels, got.sample_rate) == (want.channels,
                                               want.sample_rate)
    for lo, hi, ch in ((0, 999, None), (4000, 8100, 2), (100, 100, 1)):
        a, b = got.get_frame(lo, hi, ch), want.get_frame(lo, hi, ch)
        assert isinstance(a, port_audio.AudioFrame)
        assert (a.full_min_sample, a.full_max_sample, a.channels) == (
            b.full_min_sample, b.full_max_sample, b.channels)
        np.testing.assert_array_equal(a.data, b.data)
    # the pull protocol, through an audio workspace of the port
    ws = port_audio.AudioWorkspace()
    ws.add(source=got, x=100, length=500, offset=50)
    frame = ws.get_frame(0, 799, 1)
    np.testing.assert_array_equal(
        frame.data[100:600, 0], want.get_frame(50, 549, 1).data[:, 0])
    assert not frame.data[:100].any() and not frame.data[600:].any()


def test_muxers_write_equal_packets(tmp_path):
    """The port's muxer and the JAX package's, given the same frames,
    write the same packets."""
    got = _write_sample(libav, str(tmp_path / 'port.avi'), frames=12)
    want = _write_sample(ref_libav, str(tmp_path / 'ref.avi'), frames=12)
    for stream in (0, 1):
        assert _packets(libav, got, stream) == _packets(ref_libav, want,
                                                        stream)


def test_muxer_checks_match_jax(tmp_path):
    for lib in (libav, ref_libav):
        with lib.AVMuxer(str(tmp_path / ('m_%s.avi' % lib.__name__))) as mux:
            v = mux.add_video_stream('mpeg4', (64, 48), 25)
            a = mux.add_audio_stream('pcm_s16le', 8000, 2)
            with pytest.raises(ValueError, match='stream geometry'):
                mux.write_video_frame(v, np.zeros((48, 60, 4), np.uint8))
            with pytest.raises(ValueError, match='stream geometry'):
                mux.write_video_frame_planar(
                    v, np.zeros((48, 64), np.uint8),
                    np.zeros((24, 31), np.uint8),
                    np.zeros((24, 32), np.uint8))
            with pytest.raises(ValueError, match='channels'):
                mux.write_audio_frame(a, np.zeros((10, 1), np.float32))
            with pytest.raises(RuntimeError, match='copy stream'):
                mux.run()
        with pytest.raises(IOError):
            lib.AVContainer(str(tmp_path / 'missing.avi'))


def test_copy_stream_remux_matches_jax(sample, tmp_path):
    """The reference's stream-copy muxer (``add_video_stream(source,
    codec, ...)`` then ``run``) over a demuxer."""
    out = {}
    for lib in (libav, ref_libav):
        path = str(tmp_path / ('copy_%s.avi' % lib.__name__))
        mux = lib.AVMuxer(path)
        mux.add_video_stream(lib.AVDemuxer(sample, 0), 'mpeg4', 25, (64, 48))
        mux.run()
        out[lib] = _packets(lib, path, 0)
    assert out[libav] == out[ref_libav]
    assert [p[0] for p in out[libav]] == [p[0] for p in
                                          _packets(libav, sample, 0)]


# --- matroska, timecode, formats -----------------------------------------

class _Tone:
    def __init__(self, lib):
        self.lib = lib

    def get_frame(self, min_sample, max_sample, channels):
        t = np.arange(min_sample, max_sample + 1) / 8000.0
        data = np.repeat((0.5 * np.sin(2 * math.pi * 440 * t))[:, None],
                         channels, axis=1)
        return self.lib.AudioFrame(min_sample, max_sample, channels,
                                   data=data.astype(np.float32))


def test_matroska_audio_bytes_match_jax(tmp_path):
    from canvas_tpu import audio as ref_audio
    got, want = str(tmp_path / 'port.mkv'), str(tmp_path / 'ref.mkv')
    matroska.write_audio_pcm_float(got, _Tone(port_audio), 0, 7999, 8000, 2)
    ref_mkv.write_audio_pcm_float(want, _Tone(ref_audio), 0, 7999, 8000, 2)
    assert open(got, 'rb').read() == open(want, 'rb').read()
    dec = libav.AVAudioDecoder(got, channels=2)
    np.testing.assert_allclose(
        dec.get_frame(0, 7999).data,
        _Tone(port_audio).get_frame(0, 7999, 2).data, atol=0)


def test_matroska_video_bytes_match_jax(sample, tmp_path):
    """Packets remuxed into Matroska by each package's writer, with tags
    and cues: the same bytes, and libavformat reads them back."""
    packets = _packets(libav, sample, 0)
    files = {}
    for mkv in (matroska, ref_mkv):
        path = str(tmp_path / ('%s.mkv' % mkv.__name__))
        with open(path, 'wb') as fd:
            writer = mkv.MatroskaWriter(fd)
            writer.write_start(writing_app='canvas-test', duration=0.0,
                               timecode_scale=1000000)
            writer.write_tracks([mkv.Track(
                number=1, uid=1, type_=mkv.TrackType.VIDEO,
                codec_id='V_MPEG4/ISO/ASP', lacing=False,
                default_duration=40_000_000,
                video=mkv.TrackVideo(64, 48))])
            writer.add_tag(mkv.Tag(
                [mkv.Target('MOVIE', mkv.VideoTargetTypeValue.MOVIE)],
                [mkv.SimpleTag('TITLE', 'tone')]))
            for i, pkt in enumerate(packets):
                writer.write_simple_block(1, i * 40, pkt[0],
                                          keyframe=pkt[4])
            writer.write_end(duration=float(len(packets) * 40))
        files[mkv] = open(path, 'rb').read()
    assert files[matroska] == files[ref_mkv]
    assert [p[0] for p in _packets(
        libav, str(tmp_path / ('%s.mkv' % matroska.__name__)), 0)] == [
            p[0] for p in packets]
    for fn in ('encode_id', 'encode_size', 'encode_uint', 'encode_int'):
        for v in (0, 1, 126, 127, 128, 0x1A45DFA3, 1 << 40):
            assert getattr(matroska, fn)(v) == getattr(ref_mkv, fn)(v)


@pytest.mark.parametrize('make', [
    lambda m: m.Frames(), lambda m: m.TimeAndFrames(25),
    lambda m: m.TimeAndFrames(24, frames_separator='.'),
    lambda m: m.NtscDropFrame()],
    ids=['frames', 'time_and_frames', 'separator', 'ntsc_drop'])
def test_timecode_matches_jax(make):
    got, want = make(timecode), make(ref_timecode)
    for frame in list(range(-40, 40)) + list(range(0, 30 * 60 * 61, 997)):
        text = got.format(frame)
        assert text == want.format(frame)
        assert got.parse(text) == want.parse(text)
    assert got.get_major_ticks() == want.get_major_ticks()


def test_probe_container_matches_jax(sample):
    got, want = formats.probe_container(sample), ref_formats.probe_container(
        sample)
    assert repr(got) == repr(want)
    assert got.detected == want.detected
    assert len(got.streams) == len(want.streams) == 2
    for a, b in zip(got.streams, want.streams):
        assert (a.type, a.length) == (b.type, b.length)
        assert a.detected == b.detected
    assert (formats.KnownColorPrimaries.__dict__.keys()
            == ref_formats.KnownColorPrimaries.__dict__.keys())
