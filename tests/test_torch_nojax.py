"""The PyTorch port stands on its own: in a fresh interpreter whose
import system refuses every ``jax``/``jaxlib`` module, the JAX package
(``canvas_tpu``) and the repository's root scripts and studies
(``bench``, ``benchmarks``, ``scripts``), it imports, plans and renders
on the CPU the headline timeline (also sharded over a mesh of ``cpu``
entries, ``canvas_tpu_torch.mesh``, and resharded by rows through
``render_sharded``), the mixed-content timeline (DV clips
staged by the port, through animated scalers), the pulldown and planar
clips (replayed from the plan cache, paced), a coded round trip through
the subsample filters and a graph whose source
the planner host-stages, all built from the port's own classes
(``canvas_tpu_torch.timelines``, ``canvas_tpu_torch.process``), pulls
display frames (``render_display``, and a playback engine's
``display_frame`` at quality 5), runs the studies'
``--check --device cpu`` entry points
(canvas_tpu_torch.studies), writes a 12-frame ``write_video`` file with
audio, decodes it with ``AVVideoDecoder`` and renders a batch of
``timelines.decoded_planar_clip`` (the port's own build of the native
library, and its ``audio``, ``x264``, ``faac``, ``libdv``, ``formats``,
``timecode`` and ``matroska`` imported), loads the editor's plugins (the
port's ``libav.plugin``), renders the editor's headline project (equal to
the headline) and its cut, imports the written file through the libav
plugin into an edited, saved and reloaded project, and renders its
decoder's RGBA through ``u8_linearize``; imports every module of the
editor's UI layer (``canvas_tpu_torch.editor.ui``, its entry point
``canvas_tpu_torch.editor.__main__``), pulls a crossfade
(``transitions``) through a ``pullqueue.VideoPullQueue``, plays a tone
through an ``audioout.AudioPlayer``, and opens the headline project in
an ``EditorApp`` whose thumbnails and painted timeline it takes, all
through the render programs (``render.program_stats``, ``explain``'s
program line); pulls
through the torch arms on the CPU and times both branches of
``process.time_get_frame`` there, and reaches the rest of ``process``'s
names (the pull queue, ``NS_PER_SEC``, the shims); and nothing it runs
even tries
such an import (a refused attempt could be swallowed by an
optional-import probe, so attempts are recorded)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The import blocker every script here starts with: it refuses JAX, the
#: JAX package and the root scripts, and records each attempt.
BLOCKER = textwrap.dedent('''
    import importlib.abc
    import sys
    import time

    ATTEMPTS = []

    REFUSED = ('jax', 'jaxlib', 'canvas_tpu', 'bench', 'benchmarks',
               'scripts')

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split('.')[0] in REFUSED:
                ATTEMPTS.append(name)
                raise ImportError('blocked: ' + name)
            return None

    sys.meta_path.insert(0, NoJax())
''')

SCRIPT = BLOCKER + textwrap.dedent('''
    import numpy as np
    import canvas_tpu_torch
    import canvas_tpu_torch.ops.cuda_ops
    from canvas_tpu_torch.render import RenderPlanner, box2i
    from canvas_tpu_torch import backend, process, timelines

    ws = timelines.build_timeline(64)
    planner = RenderPlanner(ws, box2i(0, 0, 319, 179), device='cpu')
    out = planner.render(0, 2)
    assert out.shape == (2, 4, 180, 320) and out.dtype == np.float16
    assert np.isfinite(out).all() and out[:, 3].max() > 0
    for _s, _n, batch in planner.iter_batches(2, 4, batch=2):
        assert tuple(batch.shape) == (2, 4, 180, 320)

    from canvas_tpu_torch import mesh as port_mesh
    from canvas_tpu_torch.render import render_sharded
    cpu2 = port_mesh.Mesh(['cpu', 'cpu'], ('frames',))
    parts = [o for _s, _n, o in planner.iter_batches(0, 4, batch=4,
                                                     mesh=cpu2)]
    assert all(isinstance(o, port_mesh.ShardedFrames) for o in parts)
    assert (np.concatenate([np.asarray(o) for o in parts])
            == planner.render(0, 4)).all()
    grid = port_mesh.Mesh([['cpu'] * 2] * 2, ('frames', 'space'))
    out = render_sharded(ws, box2i(0, 0, 319, 179), 0, 3, mesh=grid,
                         spatial_axis='space', device_out=True)
    assert 'space' in str(out.sharding) and len(out.shards) == 4
    assert (np.asarray(out) == out.numpy()).all()
    assert (out.numpy() == planner.render(0, 3)).all()

    mixed = RenderPlanner(timelines.mixed_timeline(16),
                          box2i(0, 0, 1919, 1079), device='cpu')
    mixed.stage_cache_mb = 0
    got = [(s, n) for s, n, out in mixed.iter_batches(0, 3, batch=2)
           if np.isfinite(out.numpy()).all()]
    assert got == [(0, 1), (1, 2)], got

    clip = RenderPlanner(timelines.pulldown_clip(),
                         timelines.PULLDOWN_WINDOW, device='cpu')
    first = [out.clone() for _s, _n, out in clip.iter_batches(0, 4, batch=4)]
    assert len(clip._plan_cache) == 1
    again = [out for _s, _n, out in clip.iter_batches(0, 4, batch=4,
                                                      max_inflight=2)]
    assert len(first) == 1 and (first[0] == again[0]).all()
    assert 'field_interleave' in clip.explain(0, 4)
    planar = RenderPlanner(timelines.planar_clip(2),
                           box2i(1800, 1000, 1919, 1079), device='cpu')
    out = planar.render(0, 2)
    assert out.shape == (2, 4, 80, 120) and np.isfinite(out).all()
    with backend.force_backend('numpy'):
        coded = process.MPEG2SubsampleFilter(process.SolidColorVideoSource(
            (0.5, 0.25, 0.125, 1.0))).get_frame(0)
        back = process.PlanarReconstructionFilter(
            type('One', (process.CodedImageSource,),
                 {'get_frame': lambda self, i, quality=0: coded})())
        px = back.get_frame_f32(0, box2i(0, 0, 719, 479)).data[:, 100, 100]
        assert np.abs(px - (0.5, 0.25, 0.125, 1.0)).max() < 0.02, px
        assert len(process.DVSubsampleFilter(back).get_frame(0)) == 3

    class Custom(process.VideoSource):
        def _render_f16(self, frame_index, frame):
            data = np.full((4, frame.full_window.height,
                            frame.full_window.width), 0.5, np.float16)
            data[0] = frame_index * 0.125
            frame.data = data
            frame.current_window = frame.full_window

    ws = process.VideoWorkspace()
    ws.add(source=process.SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)), x=0,
           length=8, z=0)
    ws.add(source=Custom(), x=0, length=8, z=1)
    staged = RenderPlanner(ws, box2i(0, 0, 63, 31), device='cpu')
    out = staged.render(0, 4)
    assert out.shape == (4, 4, 32, 64) and out[3, 0, 0, 0] != out[0, 0, 0, 0]
    bgra = planner.render_display(3, intent=1.25, display_size=(160, 90),
                                  transport='rgb24')
    assert bgra.shape == (90, 160, 4) and bgra.dtype == np.uint8
    assert planner.render_display(3, transport='yuv420').shape == \\
        (180, 320, 4)

    from fractions import Fraction
    from canvas_tpu_torch.playback import VideoPlaybackEngine
    shown = {}
    engine = VideoPlaybackEngine(
        ws, process.SystemPresentationClock(), Fraction(30, 1),
        box2i(0, 0, 63, 31), lambda i, f: shown.__setitem__(i, f),
        device='cpu')
    try:
        engine.set_quality(5)
        engine.display_frame(2)
    finally:
        engine.stop()
    assert shown[2].shape == (32, 64, 4) and shown[2].dtype == np.uint8

    import torch
    from canvas_tpu_torch.studies import (fold_interior_study,
                                          fold_tile_study, vpu_roofline)
    assert fold_interior_study.main(['--check', '--batch', '2',
                                     '--device', 'cpu']) == 0
    assert fold_tile_study.main(['--check', '--device', 'cpu']) == 0
    assert vpu_roofline.main(['--check', '--device', 'cpu']) == 0

    import os
    import tempfile
    from canvas_tpu_torch import (faac, formats, libav, libdv, matroska,
                                  timecode, x264)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, 'headline.avi')
    tone = process.AudioWorkspace()
    tone.add(source=process.AudioFrame(0, 9599, 2, data=np.full(
        (9600, 2), 0.25, np.float32)), x=0, length=9600)
    libav.write_video(path, timelines.build_timeline(64), tone, 0, 12,
                      frame_size=(320, 180), frame_rate=25, batch=4,
                      format='avi', audio_codec='pcm_s16le', device='cpu')
    dec = libav.AVVideoDecoder(path)
    assert dec.get_frame(11).planes[0].shape == (180, 320)
    assert dec.get_frame(12) is None
    assert formats.probe_container(path).streams[0].length == 12
    assert timecode.TimeAndFrames(25).format(30) == '00:00:01:05'
    clip = timelines.decoded_planar_clip(os.path.join(tmp, 'c8.avi'),
                                         length=4, width=160, height=96,
                                         device='cpu')
    decoded = RenderPlanner(clip, box2i(0, 0, 159, 95), device='cpu')
    decoded.stage_cache_mb = 0
    (_s, n, out), = decoded.iter_batches(0, 4, batch=4)
    assert n == 4 and tuple(out.shape) == (4, 4, 96, 160)
    assert bool(torch.isfinite(out).all()) and float(out[:, 3].min()) == 1.0
    assert float(out[3, 0].mean()) > float(out[0, 0].mean())

    from canvas_tpu_torch import ezlist, logging, sortlist
    from canvas_tpu_torch.editor import (graph, model, plugins, settings,
                                         yamlio)
    from canvas_tpu_torch.editor.plugins import libav_plugin
    settings.set_settings_path(None)
    plugins.PluginManager.load_all()
    assert [m.module for m in plugins.PluginManager.plugin_modules] == [
        libav_plugin]
    for p in plugins.PluginManager.find_plugins(enabled_only=False):
        plugins.PluginManager.set_plugin_enabled(p, True)
    small = box2i(0, 0, 95, 63)
    _assets, head = timelines.editor_headline(16)
    video = timelines.editor_video(head)
    assert isinstance(video, graph.SpaceVideoManager)
    ed = RenderPlanner(video, small, device='cpu').render(0, 2)
    assert (ed == RenderPlanner(timelines.build_timeline(16), small,
                                device='cpu').render(0, 2)).all()
    cut = RenderPlanner(timelines.editor_video(timelines.editor_cut(128)[1]),
                        small, device='cpu')
    cut.stage_cache_mb = 0
    assert np.isfinite(cut.render(57, 59)).all()
    src = libav_plugin.LibavSourcePlugin.create_source_from_file('h', path)
    assets = model.AssetList()
    assets['h'] = model.PluginSourceAsset(
        'h', libav_plugin.LibavSourcePlugin.plugin_urn, src.get_definition())
    space = model.Space('s', plugins.VideoFormat(
        full_frame=box2i(0, 0, 319, 179), frame_rate=25),
        plugins.AudioFormat(sample_rate=48000))
    assets['s'] = model.SpaceAsset(space, name='s')
    stack = model.UndoStack()
    clip = model.Clip(type='video', x=0, y=0.0, length=12, height=1.0,
                      source=model.AssetStreamRef('h', '0'), offset=0)
    stack.push(model.InsertItemCommand(space, clip, 0))
    stack.push(model.AdjustClipLengthCommand(clip, -4))
    edited = timelines.editor_video(assets['s'])
    with backend.force_backend('numpy'):
        assert edited.get_frame_f16(9, box2i(0, 0, 319, 179)) \
            .current_window.empty()
        assert not edited.get_frame_f16(5, box2i(0, 0, 319, 179)) \
            .current_window.empty()
    project = yamlio.load(yamlio.dump(model.Project(assets=assets)))
    project.fixup()
    assert len(project.assets['s'].space) == 1
    rgba = RenderPlanner(libav_plugin._RgbaDecoderSource(
        libav.AVVideoDecoder(path), 320, 180), box2i(0, 0, 319, 179),
        device='cpu').render(0, 2)
    assert rgba.shape == (2, 4, 180, 320) and (rgba[:, 3] == 1.0).all()

    import importlib
    import threading
    from canvas_tpu_torch import audioout, pullqueue, transitions
    from canvas_tpu_torch.editor import ui
    for name in ('app', 'canvas_models', 'gtk', 'gtk_ctypes', 'mainwindow',
                 'notification', 'paint', 'qt', 'renderprogress', 'ruler',
                 'settings_models', 'thumbnails', 'tkui'):
        importlib.import_module('canvas_tpu_torch.editor.ui.' + name)
    entry = importlib.import_module('canvas_tpu_torch.editor.__main__')
    assert callable(entry.main)
    fade = transitions.Crossfade().create_source(
        process.SolidColorVideoSource((1, 0, 0, 1)),
        process.SolidColorVideoSource((0, 0, 1, 1)), 8)
    queue = pullqueue.VideoPullQueue(device='cpu')
    pulled = threading.Event()
    got = {}
    queue.enqueue(fade, 4, small, lambda i, f, d: (got.update(f=f),
                                                   pulled.set()))
    assert pulled.wait(60) and got['f'] is not None
    assert abs(float(got['f'].data[2, 5, 5]) - 0.5) < 0.01
    queue.close()
    chunks = []
    player = audioout.AudioPlayer(8000, 2, tone, sink=lambda d: chunks.append(
        len(d)))
    player.play(1)
    deadline = time.time() + 10
    while not chunks and time.time() < deadline:
        time.sleep(0.01)
    player.close()
    assert chunks
    app = ui.EditorApp(load_plugins=False, device='cpu')
    app.set_asset_list(timelines.editor_headline(16)[0])
    editor = app.open_space('headline')
    painter = ui.ThumbnailPainter(editor.video_stream, small, size=(16, 9),
                                  count=2, device='cpu')
    painter.set_range(0, 16)
    painter.request_all()
    deadline = time.time() + 60
    while painter.thumbnail(1) is None and time.time() < deadline:
        time.sleep(0.05)
    assert painter.thumbnail(1).shape == (9, 16, 4)
    painter._queue.close()
    buf = editor.paint_timeline(160, 60, thumbnails={
        editor.space[0]: painter.thumbnail(0)})
    assert buf.shape == (60, 160, 4)
    app.close()

    # the eager pull and the rest of process: time_get_frame's two
    # branches with the torch arms on the CPU, and the shims
    with backend.force_backend('torch', 'cpu'):
        head = timelines.build_timeline(64)
        win = box2i(0, 0, 319, 179)
        frame = head.get_frame_f16(3, win)
        assert type(frame.data).__name__ == 'Tensor', type(frame.data)
        assert process.time_get_frame(head, 0, 3, win) > 0
        assert process.time_get_frame(head, 0, 1, win, force_eager=True) > 0
    assert process.VideoPullQueue is canvas_tpu_torch.pullqueue.VideoPullQueue
    assert process.NS_PER_SEC == canvas_tpu_torch.NS_PER_SEC == 10 ** 9
    assert isinstance(process.check_context_supported(), bool)
    assert process.enable_glib_logging() is None
    try:
        process.Offscreen()
    except NotImplementedError:
        pass
    else:
        raise AssertionError('Offscreen() did not raise')
    from canvas_tpu_torch import profiling, render as port_render
    assert port_render.Node is canvas_tpu_torch.ir.Node
    assert profiling.timed is profiling.Timer
    assert canvas_tpu_torch.libav.available() in (True, False)

    # the render programs everything above ran through: one per
    # signature, replayed; explain reports them
    stats = port_render.program_stats()
    assert stats['calls'] > stats['captures'] > 0 and stats['replays'] > 0
    assert any('display' in p['key'] for p in stats['programs']), stats
    for _rep in range(2):           # eagerly, then captured
        planner.render(2, 4)
    assert 'program CAPTURED' in planner.explain(2, 4)

    loaded = sorted(m for m in sys.modules if m.split('.')[0] in REFUSED)
    assert not loaded, loaded
    assert not ATTEMPTS, ATTEMPTS
    print('NOJAX_OK')
''')


def test_port_runs_without_jax():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'NOJAX_OK' in proc.stdout
