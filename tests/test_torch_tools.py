"""The port's user entry points (``canvas_tpu_torch.tools``) against their
``scripts/`` counterparts, on the CPU: each script runs in this process
as its ``__main__`` on CPU JAX, each tool through ``main(argv)`` with
``--device cpu`` where it renders, on the same inputs, made here with
the port's muxer. Libav's codecs run on one thread
(``CANVAS_AV_THREADS=1``), so the same frames give the same packets.

Tolerances:

- ``explain`` (``--demo``, and the project ``demo_project`` saves): every
  line equal once the JAX package's ``program COMPILED`` / ``program not
  compiled`` reads ``program CAPTURED`` / ``program not captured`` and
  the port's hit and miss counts are taken off the end of its two cache
  lines (``CACHE_COUNTS``); the port prints no line of its own
  (``PORT_ONLY_LINES`` is empty). A
  project saved from ``timelines.editor_headline`` cannot be reloaded by
  either package (its runtime assets hold Python sources, which YAML
  cannot construct again), so the project is the demo's;
- ``decode_raw_image``: the same PPM header, pixels within 1 u8 step
  (measured: none differs);
- ``write_raw_audio``: the same Matroska bytes;
- ``demo_project``: the same media and export bytes;
- the encoders: the decoded video frames (every plane, u8) and the
  decoded audio samples equal; the files differ only in their writing
  app (``canvas_tpu_torch <tool>``) and the offsets it shifts. On top,
  ``encode_x264_mkv`` and ``audio_roundtrip`` pass the checks
  ``tests/test_encoders.py`` makes of the scripts (an H.264 / AAC
  stream, a worst sampled AAC delta below 0.25);
- ``play_demo``: both present frames (the count depends on the host's
  clock, so it is not compared).
"""

import contextlib
import importlib
import io
import logging
import os
import re
import runpy
import sys
from fractions import Fraction
from unittest import mock

import numpy as np
import pytest

from canvas_tpu_torch import libav

if not libav.available():
    pytest.skip('native canvas_av unavailable', allow_module_level=True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Lines of ``explain`` that the port prints and the JAX script does not.
PORT_ONLY_LINES = ()

#: The end of the port's stage- and plan-cache lines: the caches' hits
#: and misses (``profiling``'s counters), which the JAX script does not
#: print.
CACHE_COUNTS = re.compile(r'^((?:stage|plan) cache: .*); \d+ hits, '
                          r'\d+ misses$')

#: The JAX package's program status words, as the port says them.
STATUS = {'program COMPILED': 'program CAPTURED',
          'program not compiled': 'program not captured'}


@pytest.fixture(scope='module', autouse=True)
def one_codec_thread():
    with mock.patch.dict(os.environ, {'CANVAS_AV_THREADS': '1'}):
        yield


def run_script(name, *argv):
    """``scripts/<name>.py`` run as ``__main__`` in this process with
    *argv*; its standard output. The environment, ``sys.path`` and the
    root logger are restored after it."""
    path = os.path.join(REPO, 'scripts', name + '.py')
    out = io.StringIO()
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        with mock.patch.object(sys, 'argv',
                               [path] + [str(a) for a in argv]), \
                mock.patch.object(sys, 'path', list(sys.path)), \
                mock.patch.dict(os.environ), contextlib.redirect_stdout(out):
            try:
                runpy.run_path(path, run_name='__main__')
            except SystemExit as done:
                assert done.code in (0, None), (name, done.code,
                                                out.getvalue())
    finally:
        root.handlers[:] = handlers       # test_audio.py adds a handler
        root.setLevel(level)
    return out.getvalue()


def run_tool(name, *argv):
    """``canvas_tpu_torch.tools.<name>.main(argv)``; its standard
    output."""
    tool = importlib.import_module('canvas_tpu_torch.tools.' + name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main([str(a) for a in argv]) == 0, out.getvalue()
    return out.getvalue()


@pytest.fixture(scope='module')
def media(tmp_path_factory):
    """A 6-frame NTSC DV file with a stereo tone, and a 10-frame 64x48
    MPEG-4 AVI without audio."""
    tmp = tmp_path_factory.mktemp('media')
    rate, n = 48000, 6
    t = np.arange(rate * n * 1001 // 30000)
    wave = (0.5 * np.sin(2 * np.pi * 440.0 * t / rate)).astype(np.float32)
    stereo = np.stack([wave, -wave], axis=1)
    dv = str(tmp / 'in.dv')
    mux = libav.AVMuxer(dv, format='dv')
    vstream = mux.add_video_stream('dvvideo', (720, 480),
                                   Fraction(30000, 1001))
    astream = mux.add_audio_stream('pcm_s16le', rate, 2)
    rgba = np.zeros((480, 720, 4), np.uint8)
    pos = 0
    with mux:
        for i in range(n):
            rgba[..., 0] = 30 * i
            rgba[..., 1] = 160
            rgba[..., 3] = 255
            rgba[100:200, 100 + 20 * i:300 + 20 * i, 2] = 200
            mux.write_video_frame(vstream, rgba)
            upto = rate * (i + 1) * 1001 // 30000
            mux.write_audio_frame(astream, stereo[pos:upto])
            pos = upto
    avi = str(tmp / 'in.avi')
    with libav.AVMuxer(avi) as mux:
        vstream = mux.add_video_stream('mpeg4', (64, 48), 25,
                                       bit_rate=400_000)
        mux.start()
        for i in range(10):
            frame = np.zeros((48, 64, 4), np.uint8)
            frame[:, :, 0] = i * 20
            frame[:, :, 3] = 255
            mux.write_video_frame(vstream, frame)
    return {'dv': dv, 'avi': avi}


@pytest.fixture(scope='module')
def plugin_state():
    """Both editors' settings and plugin managers, restored after the
    demos (which enable the libav plugins in a settings file of their
    own)."""
    from canvas_tpu.editor import settings as ref_settings
    from canvas_tpu.editor.plugins import PluginManager as RefManager
    from canvas_tpu_torch.editor import settings
    from canvas_tpu_torch.editor.plugins import PluginManager
    saved = [(m, m._instance, m._path_override)
             for m in (settings, ref_settings)]
    yield
    for m, instance, path in saved:
        m._instance, m._path_override = instance, path
    PluginManager._reset_for_tests()
    RefManager._reset_for_tests()


@pytest.fixture(scope='module')
def demos(tmp_path_factory, plugin_state):
    """The work directories of ``demo_project``: the script's and the
    tool's, each with its stdout."""
    ref = tmp_path_factory.mktemp('demo_script')
    port = tmp_path_factory.mktemp('demo_tool')
    return {'script': (ref, run_script('demo_project', ref)),
            'tool': (port, run_tool('demo_project', port, '--device',
                                    'cpu'))}


def _as_port(text):
    for jax_word, port_word in STATUS.items():
        text = text.replace(jax_word, port_word)
    return text.splitlines()


def _hold_explain(script_out, tool_out):
    want, got = _as_port(script_out), tool_out.splitlines()
    assert sum(bool(CACHE_COUNTS.match(line)) for line in got) == 2
    got = [CACHE_COUNTS.sub(r'\1', line) for line in got]
    assert [line for line in got if line not in want] == \
        list(PORT_ONLY_LINES)
    assert got == want
    assert any('program not captured' in line for line in got)


def test_explain_demo_matches_the_script():
    _hold_explain(run_script('explain', '--demo'),
                  run_tool('explain', '--demo', '--device', 'cpu'))


def test_explain_project_matches_the_script(demos):
    ref, _out = demos['script']
    port, _out = demos['tool']
    script_out = run_script('explain', ref / 'demo_project.yaml')
    tool_out = run_tool('explain', port / 'demo_project.yaml', '--device',
                        'cpu')
    assert tool_out.startswith("space 'main'")
    assert 'planar_recon_rows' in tool_out
    _hold_explain(script_out, tool_out)


def test_decode_raw_image_matches_the_script(tmp_path):
    run_script('decode_raw_image', tmp_path / 'script.ppm')
    run_tool('decode_raw_image', tmp_path / 'tool.ppm', '--device', 'cpu')
    want = (tmp_path / 'script.ppm').read_bytes()
    got = (tmp_path / 'tool.ppm').read_bytes()
    header = b'P6\n720 480\n255\n'
    assert want[:len(header)] == got[:len(header)] == header
    a = np.frombuffer(want[len(header):], np.uint8).astype(np.int16)
    b = np.frombuffer(got[len(header):], np.uint8).astype(np.int16)
    assert a.size == b.size == 480 * 720 * 3
    differ = int(np.count_nonzero(a != b))
    assert int(np.abs(a - b).max()) <= 1, differ
    assert differ == 0          # what this CPU measured; 1 step is allowed


def test_decode_raw_image_raises_without_a_card(tmp_path, monkeypatch):
    """With no card and no ``--device cpu`` the tool raises; it never
    falls back to the CPU by itself. ``CANVAS_FORCE_CPU`` asks for it."""
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.delenv('CANVAS_FORCE_CPU', raising=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        run_tool('decode_raw_image', tmp_path / 'x.ppm')
    assert not (tmp_path / 'x.ppm').exists()
    monkeypatch.setenv('CANVAS_FORCE_CPU', '1')
    run_tool('decode_raw_image', tmp_path / 'x.ppm')
    assert (tmp_path / 'x.ppm').stat().st_size == 15 + 480 * 720 * 3


def test_write_raw_audio_matches_the_script(tmp_path):
    run_script('write_raw_audio', tmp_path / 'script.mkv')
    run_tool('write_raw_audio', tmp_path / 'tool.mkv')
    assert (tmp_path / 'tool.mkv').read_bytes() == \
        (tmp_path / 'script.mkv').read_bytes()


def test_demo_project_matches_the_script(demos):
    ref, out = demos['script']
    port, tool_out = demos['tool']
    assert tool_out.splitlines()[-1] == out.splitlines()[-1] == 'demo OK'
    for name in ('demo_media.avi', 'demo_out.avi'):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    info = libav.AVContainer(str(port / 'demo_out.avi'))
    assert (info.streams[0].codec, info.streams[0].frame_count) == \
        ('mpeg4', 76)
    info.close()


def _decoded(path):
    """Every decoded video frame's planes and 4800 decoded audio samples
    (None without an audio stream) of *path*."""
    cont = libav.AVContainer(path)
    kinds = {s.type: s for s in cont.streams}
    cont.close()
    frames = []
    if 'video' in kinds:
        dec = libav.AVVideoDecoder(path)
        while True:
            frame = dec.get_frame(len(frames))
            if frame is None:
                break
            frames.append([np.asarray(p).copy() for p in frame.planes])
    audio = None
    if 'audio' in kinds:
        audio = libav.AVAudioDecoder(path, channels=2).get_frame(
            0, 4799).data
    return kinds, frames, audio


def _hold_decoded(script_path, tool_path):
    kinds, want, want_audio = _decoded(script_path)
    got_kinds, got, got_audio = _decoded(tool_path)
    assert {k: s.codec for k, s in got_kinds.items()} == \
        {k: s.codec for k, s in kinds.items()}
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    if want_audio is None:
        assert got_audio is None
    else:
        np.testing.assert_array_equal(got_audio, want_audio)
    return got_kinds, got


@pytest.mark.parametrize('name, source, argv, wrote, frames, audio', [
    ('encode_x264_mkv', 'dv', ('6',), 6, 6, False),
    ('encode_x264_mkv', 'avi', ('10',), 10, 10, False),
    ('encode_x264_faac_mkv', 'dv', ('6',), 6, 6, True),
    ('encode_video', 'dv', ('--frames', '4', '--preset', 'ultrafast'), 4,
     4, True),
    ('encode_faac_mkv', 'dv', ('0.2',), 11, 0, True),
])
def test_encoder_matches_the_script(media, tmp_path, name, source, argv,
                                    wrote, frames, audio):
    """*wrote*: the count the tool reports (video frames, or AAC packets
    for the audio-only tool); *frames*: the video frames decoded."""
    script_out = tmp_path / 'script.mkv'
    tool_out = tmp_path / 'tool.mkv'
    run_script(name, media[source], script_out, *argv)
    device = () if name == 'encode_faac_mkv' else ('--device', 'cpu')
    said = run_tool(name, media[source], tool_out, *argv, *device)
    assert said.split()[:2] == ['wrote', str(wrote)]
    kinds, decoded = _hold_decoded(str(script_out), str(tool_out))
    assert len(decoded) == frames
    assert ('audio' in kinds) == audio
    if frames:
        assert kinds['video'].codec == 'h264'
    # the checks tests/test_encoders.py makes of the scripts
    assert tool_out.stat().st_size > 500
    assert tool_out.read_bytes().count(b'canvas_tpu_torch ' +
                                       name.encode()) == 1


def test_encode_video_keeps_an_output_without_force(media, tmp_path):
    out = tmp_path / 'kept.mkv'
    out.write_bytes(b'x')
    from canvas_tpu_torch.tools import encode_video
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        assert encode_video.main([media['avi'], str(out), '--device',
                                  'cpu']) == 1
    assert 'Will not overwrite' in said.getvalue()
    assert out.read_bytes() == b'x'


def test_audio_roundtrip_matches_the_script(tmp_path):
    script_said = run_script('test_audio', '-', tmp_path / 'script.mkv')
    said = run_tool('audio_roundtrip', '-', tmp_path / 'tool.mkv')
    worst = float(said.rsplit('worst sampled delta:', 1)[1].split()[0])
    assert worst < 0.25          # lossy AAC, but the tone must track
    assert said.splitlines()[-9:] == script_said.splitlines()[-9:]
    kinds, _frames = _hold_decoded(str(tmp_path / 'script.mkv'),
                                   str(tmp_path / 'tool.mkv'))
    assert kinds['audio'].codec == 'aac'


def test_play_demo_presents_frames(media):
    script_said = run_script('play_demo', media['avi'], '1')
    said = run_tool('play_demo', media['avi'], '1', '--device', 'cpu')
    for out in (script_said, said):
        line = out.strip().splitlines()[-1]
        assert line.startswith('presented ') and int(line.split()[1]) > 1
