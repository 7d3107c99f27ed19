"""The port's export and decode path against the JAX package's, on the
CPU: ``libav.write_video`` over ``RenderPlanner(device='cpu')``, the
packet encoders, and config8's graph over a real decode
(``timelines.decoded_planar_clip``).

Each package renders its own timeline (``bench.build_timeline`` on CPU
JAX, ``timelines.build_timeline`` on the port's plain kernels) and
encodes with its own build of ``native/canvas_av.cpp``, with
``CANVAS_AV_THREADS=1`` so that the encoders are deterministic.

Tolerances:

- The u8 frames each ``write_video`` hands its muxer (RGBA or 4:2:0
  planes): equal (the posts' gate is 1 u8 step on at most 0.1% of
  values, tests/test_torch_color.py; measured equal on this CPU).
- Video and audio packets, demuxed: byte-equal.
- The decoded clip's plan: equal to the JAX planner's, param for param.
  Its frames against ``canvas_tpu.render._eval`` of the JAX plan: at
  least 99.99% of values within 1 f16 ulp, all within atol 4e-3 (the
  port's f32 contractions sum in another order than XLA's, as in
  tests/test_torch_coded.py); against the port's own NumPy pull path:
  atol 1e-2 with at least 99% bit-equal (tests/test_chroma.py's limits).
"""

import fractions
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bench
from canvas_tpu import audio as ref_audio
from canvas_tpu import coded as ref_coded
from canvas_tpu import framefuncs as ref_framefuncs
from canvas_tpu import libav as ref_libav
from canvas_tpu import render as ref_render
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu_torch import audio, coded, framefuncs, ir, libav, sources
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines, x264
from canvas_tpu_torch.basetypes import box2i

CPU = torch.device('cpu')
WINDOW = (0, 0, 319, 175)
SIZE = (320, 176)


@pytest.fixture(autouse=True)
def _one_codec_thread(monkeypatch):
    monkeypatch.setenv('CANVAS_AV_THREADS', '1')


def _capture(lib, monkeypatch):
    """Record copies of the u8 frames *lib*'s muxer is handed."""
    got = []
    rgba, planar = (lib.AVMuxer.write_video_frame,
                    lib.AVMuxer.write_video_frame_planar)

    def write(self, stream, frame):
        got.append(np.array(frame))
        return rgba(self, stream, frame)

    def write_planar(self, stream, y, cb, cr):
        got.append((np.array(y), np.array(cb), np.array(cr)))
        return planar(self, stream, y, cb, cr)

    monkeypatch.setattr(lib.AVMuxer, 'write_video_frame', write)
    monkeypatch.setattr(lib.AVMuxer, 'write_video_frame_planar', write_planar)
    return got


def _packets(path, stream=0):
    demux = libav.AVDemuxer(path, stream)
    out = []
    while True:
        pkt = demux.get_next_packet()
        if pkt is None:
            break
        out.append((pkt.data, pkt.pts, pkt.dts, pkt.keyframe))
    demux.close()
    return out


def _same_frames(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for p, q in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert p.dtype == q.dtype == np.uint8 and p.shape == q.shape
            np.testing.assert_array_equal(p, q)


def _tone_workspace(lib):
    """A seeded two-item audio workspace of *lib*."""
    rng = np.random.RandomState(12)
    noise = rng.uniform(-0.5, 0.5, (48000, 2)).astype(np.float32)
    t = np.arange(48000) / 48000.0
    tone = np.repeat((0.3 * np.sin(2 * math.pi * 330 * t))[:, None], 2,
                     axis=1).astype(np.float32)
    ws = lib.AudioWorkspace()
    ws.add(source=lib.AudioFrame(0, 47999, 2, data=tone), x=0, length=48000)
    ws.add(source=lib.AudioFrame(0, 47999, 2, data=noise), x=3000,
           length=9000, offset=100, z=1)
    return ws


# --- write_video ----------------------------------------------------------

@pytest.mark.parametrize('transport', ['rgba_u8', 'yuv420'])
def test_write_video_matches_jax(tmp_path, monkeypatch, transport):
    """The headline at 320x176, frames 0..11 in batches of 4."""
    ref_in = _capture(ref_libav, monkeypatch)
    got_in = _capture(libav, monkeypatch)
    want, got = str(tmp_path / 'ref.avi'), str(tmp_path / 'port.avi')
    kw = dict(frame_size=SIZE, frame_rate=25, batch=4, transport=transport,
              format='avi', bit_rate=2_000_000)
    ref_libav.write_video(want, bench.build_timeline(64), None, 0, 12, **kw)
    libav.write_video(got, timelines.build_timeline(64), None, 0, 12,
                      device='cpu', **kw)
    assert len(got_in) == 12
    _same_frames(got_in, ref_in)
    if transport == 'yuv420':
        assert got_in[0][0].shape == (176, 320)
        assert got_in[0][1].shape == (88, 160)
    else:
        assert got_in[0].shape == (176, 320, 4)
    packets = _packets(got)
    assert len(packets) == 12
    assert packets == _packets(want)
    # the decoder reads back what was written
    dec = libav.AVVideoDecoder(got)
    assert dec.get_frame(11).planes[0].shape == (176, 320)
    assert dec.get_frame(12) is None


def test_write_video_with_audio_matches_jax(tmp_path, monkeypatch):
    """A seeded audio workspace through pcm_s16le beside the video."""
    want, got = str(tmp_path / 'ref.avi'), str(tmp_path / 'port.avi')
    kw = dict(frame_size=SIZE, frame_rate=fractions.Fraction(25), batch=4,
              format='avi', audio_codec='pcm_s16le', sample_rate=48000,
              channels=2)
    ref_libav.write_video(want, bench.build_timeline(64),
                          _tone_workspace(ref_audio), 2, 10, **kw)
    libav.write_video(got, timelines.build_timeline(64),
                      _tone_workspace(audio), 2, 10, device='cpu', **kw)
    streams = libav.AVContainer(got).streams
    a = next(i for i, s in enumerate(streams) if s.type == 'audio')
    v = next(i for i, s in enumerate(streams) if s.type == 'video')
    assert _packets(got, a) == _packets(want, a)
    assert _packets(got, v) == _packets(want, v)
    samples = libav.AVAudioDecoder(got).get_frame(0, 8 * 1920 - 1).data
    pcm = _tone_workspace(audio).get_frame(2 * 1920, 10 * 1920 - 1, 2).data
    np.testing.assert_allclose(samples, pcm, atol=1.0 / 32767)


def test_unbatched_path_matches_batched(tmp_path, monkeypatch):
    """``use_batch=False`` pulls frame by frame through the NumPy path;
    its u8 frames equal the batched render's, and the JAX package's
    unbatched path's."""
    batched = _capture(libav, monkeypatch)
    kw = dict(frame_size=SIZE, frame_rate=25, batch=3, format='avi')
    libav.write_video(str(tmp_path / 'a.avi'), timelines.build_timeline(64),
                      None, 20, 27, device='cpu', **kw)
    monkeypatch.undo()
    monkeypatch.setenv('CANVAS_AV_THREADS', '1')
    pulled = _capture(libav, monkeypatch)
    ref_pulled = _capture(ref_libav, monkeypatch)
    with port_backend.force_backend('numpy'):
        libav.write_video(str(tmp_path / 'b.avi'),
                          timelines.build_timeline(64), None, 20, 27,
                          device='cpu', use_batch=False, **kw)
    ref_libav.write_video(str(tmp_path / 'c.avi'), bench.build_timeline(64),
                          None, 20, 27, use_batch=False, **kw)
    _same_frames(pulled, batched)
    _same_frames(pulled, ref_pulled)
    assert _packets(str(tmp_path / 'b.avi')) == _packets(
        str(tmp_path / 'c.avi'))


ERRORS = {
    'window_size': dict(window=(0, 0, 99, 99)),
    'transport': dict(transport='rgb24'),
    'yuv420_unbatched': dict(transport='yuv420', use_batch=False),
    'audio_without_codec': dict(audio=True),
}


@pytest.mark.parametrize('case', sorted(ERRORS))
def test_write_video_refuses_as_jax(tmp_path, case):
    kw = dict(ERRORS[case])
    messages = []
    for lib, box, ws in ((libav, box2i, audio), (ref_libav, ref_box2i,
                                                 ref_audio)):
        args = dict(kw)
        if 'window' in args:
            args['window'] = box(*args['window'])
        src = ws.AudioWorkspace() if args.pop('audio', False) else None
        if lib is libav:
            args['device'] = 'cpu'
        with pytest.raises(ValueError) as err:
            lib.write_video(str(tmp_path / 'x.avi'),
                            timelines.build_timeline(8), src, 0, 2,
                            frame_size=SIZE, **args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_write_video_needs_the_card_or_cpu(tmp_path, monkeypatch):
    """``device=None`` means the card: without one it raises before any
    file is made; a ``mesh=`` that is not a ``mesh.Mesh`` is refused as
    early (write_video over a mesh: test_torch_sharded.py)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    path = tmp_path / 'x.avi'
    with pytest.raises(RuntimeError, match='CUDA'):
        libav.write_video(str(path), timelines.build_timeline(8), None, 0, 2,
                          frame_size=SIZE)
    with pytest.raises(TypeError, match='Mesh'):
        libav.write_video(str(path), timelines.build_timeline(8), None, 0, 2,
                          frame_size=SIZE, mesh=object(), device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        libav.AVVideoEncoder(timelines.build_timeline(8), 0, 1,
                             codec='mpeg4', frame_size=SIZE)
    assert not path.exists()


def test_progress_callback_stops_the_export(tmp_path):
    seen = []

    def progress(done):
        seen.append(done)
        return done < 3

    path = str(tmp_path / 'x.avi')
    libav.write_video(path, timelines.build_timeline(64), None, 0, 16,
                      frame_size=SIZE, frame_rate=25, batch=2, format='avi',
                      progress_callback=progress, device='cpu')
    # batches follow the planner's segments: frames done grow to 3 or
    # more, then the export stops with exactly what was written
    assert seen == sorted(seen) and seen[-1] >= 3 > seen[-2]
    assert seen[-1] < 16
    assert len(_packets(path)) == seen[-1]


# --- the packet encoders --------------------------------------------------

def _drain(encoder):
    out = []
    while True:
        pkt = encoder.get_next_packet()
        if pkt is None:
            return out
        out.append((pkt.data, pkt.pts, pkt.dts, pkt.keyframe))


def test_video_encoder_matches_jax():
    got = libav.AVVideoEncoder(timelines.build_timeline(64), 0, 9,
                               codec='mpeg4', frame_size=SIZE, frame_rate=25,
                               bit_rate=1_000_000, device='cpu')
    want = ref_libav.AVVideoEncoder(bench.build_timeline(64), 0, 9,
                                    codec='mpeg4', frame_size=SIZE,
                                    frame_rate=25, bit_rate=1_000_000)
    packets = _drain(got)
    assert len(packets) == 10 and got.progress == got.progress_count + 1
    assert packets == _drain(want)
    assert got.get_header() == want.get_header()


def _card(lib):
    return lib['sources'].SolidColorVideoSource(
        lib['framefuncs'].LerpFunc((0.9, 0.2, 0.1, 1.0), (0.1, 0.8, 0.6, 1.0),
                                   6),
        lib['box2i'](8, 6, 50, 40))


PORT = dict(sources=sources, framefuncs=framefuncs, coded=coded, box2i=box2i)
REF = dict(sources=ref_sources, framefuncs=ref_framefuncs, coded=ref_coded,
           box2i=ref_box2i)


@pytest.mark.parametrize('through', ['planar', 'video_encoder'])
def test_planar_encoder_matches_jax(through):
    """``AVPlanarVideoEncoder`` over ``MPEG2SubsampleFilter``, and
    ``AVVideoEncoder`` handing the same coded-image source to it."""
    def make(lib, mod):
        src = lib['coded'].MPEG2SubsampleFilter(_card(lib))
        kw = dict(codec='mpeg4', frame_size=(64, 48), frame_rate=25,
                  bit_rate=400_000)
        if through == 'planar':
            return mod.AVPlanarVideoEncoder(src, 0, 5, pix_fmt='yuv420p',
                                            **kw)
        return mod.AVVideoEncoder(src, 0, 5, **kw)

    got, want = make(PORT, libav), make(REF, ref_libav)
    with port_backend.force_backend('numpy'):
        packets = _drain(got)
    assert len(packets) == 6
    assert packets == _drain(want)
    assert got.progress == want.progress


def test_audio_encoder_matches_jax():
    got = libav.AVAudioEncoder(_tone_workspace(audio), 0, 9999, codec='aac',
                               bit_rate=128000)
    want = ref_libav.AVAudioEncoder(_tone_workspace(ref_audio), 0, 9999,
                                    codec='aac', bit_rate=128000)
    packets = _drain(got)
    assert len(packets) >= 10
    assert packets == _drain(want)
    assert got.get_header() == want.get_header() != b''
    assert (got.progress, got.progress_count) == (10000, 10000)


def test_x264_encoder_matches_jax():
    from canvas_tpu import x264 as ref_x264
    kw = dict(preset='ultrafast', width=64, height=48)
    try:
        got = x264.X264VideoEncoder(_card(PORT), 0, 5,
                                    x264.X264EncoderParams(**kw),
                                    device='cpu')
    except IOError as e:
        pytest.skip('libx264 unavailable: %s' % e)
    want = ref_x264.X264VideoEncoder(_card(REF), 0, 5,
                                     ref_x264.X264EncoderParams(**kw))
    packets = _drain(got)
    assert len(packets) == 6
    assert packets == _drain(want)
    assert (got.sps, got.pps) == (want.sps, want.pps)


# --- config8 over a real decode -------------------------------------------

def _walk(node, out=None):
    out = [] if out is None else out
    out.append(node)
    for c in node.children:
        _walk(c, out)
    return out


def _ulps_f16(a, b):
    def order(x):
        bits = x.astype(np.float16).view(np.int16).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7fff), bits)
    return np.abs(order(a) - order(b))


@pytest.fixture(scope='module')
def decoded_clip(tmp_path_factory):
    """config8's file at 160x96 and 8 frames, written by the port."""
    path = str(tmp_path_factory.mktemp('config8') / 'clip.avi')
    timelines.decoded_planar_clip(path, length=8, width=160, height=96,
                                  device='cpu')
    return path


def test_decoded_clip_file(decoded_clip):
    info = libav.AVContainer(decoded_clip).streams[0]
    assert (info.codec, info.frame_size, info.real_frame_rate) == (
        'mpeg4', (160, 96), 25)
    dec = libav.AVVideoDecoder(decoded_clip)
    planes = dec.get_frame(7).planes
    assert [p.shape for p in planes] == [(96, 160), (48, 80), (48, 80)]
    assert dec.get_frame(8) is None
    # the ramp: frame 7 is brighter than frame 0
    assert planes[0].mean() > dec.get_frame(0).planes[0].mean() + 10


def test_decoded_clip_plans_and_renders_as_jax(decoded_clip):
    clip = timelines.decoded_planar_clip(decoded_clip, length=8, width=160,
                                         height=96)
    ref = ref_coded.PlanarReconstructionFilter(
        ref_libav.AVVideoDecoder(decoded_clip), width=160, height=96)
    window = (0, 0, 159, 95)
    rp = ref_render.RenderPlanner(ref, ref_box2i(*window))
    pp = port.RenderPlanner(clip, box2i(*window), device='cpu')
    rp.stage_cache_mb = pp.stage_cache_mb = 0
    assert pp.segments(0, 8) == rp.segments(0, 8)
    rp._stage_cache, rp._frame_hints = {}, {}
    want_node = ref_render.PlanContext(rp, np.arange(0, 8),
                                       rp.window).plan(ref)
    got_node = pp._plan((0, 8))
    assert (port.sliced_signature(got_node, 8, 8)
            == ref_render._sliced_signature(want_node, 8, 8))
    for p, q in zip(port.flat_params(got_node), want_node.flat_params([])):
        assert sorted(p) == sorted(q)
        for k in q:
            v = p[k].numpy() if isinstance(p[k], torch.Tensor) else p[k]
            w = np.asarray(q[k])
            assert v.dtype == w.dtype and np.array_equal(v, w), k
    ops = [n.op for n in _walk(got_node)]
    assert ops == [n.op for n in _walk(want_node)]
    assert 'planar_recon_rows' in ops
    for a, b in zip(_walk(got_node), _walk(want_node)):
        np.testing.assert_array_equal(ir.windows_to_array(a.windows),
                                      ref_render.windows_to_array(b.windows))

    want = np.asarray(ref_render._eval(
        want_node.signature(), iter(want_node.flat_params([])), jnp,
        jax)).astype(np.float16)
    got = np.concatenate([o.numpy() for _s, _n, o in
                          pp.iter_batches(0, 8, batch=4)])
    assert got.shape == (8, 4, 96, 160) and got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=4e-3)
    assert np.mean(_ulps_f16(got, want) <= 1) >= 0.9999
    pulled = np.stack([np.asarray(clip.get_frame_f16(
        i, box2i(*window)).data) for i in (0, 7)])
    np.testing.assert_allclose(got[[0, 7]].astype(np.float32),
                               pulled.astype(np.float32), rtol=0, atol=1e-2)
    assert np.mean(got[[0, 7]].view(np.uint16)
                   == pulled.view(np.uint16)) >= 0.99
