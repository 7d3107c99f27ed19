"""The port's editor UI layer (``canvas_tpu_torch.editor.ui``: the
headless ``EditorApp``, scene models, painter, thumbnails, render job,
settings models, main window and widget shims) against the JAX
package's (``canvas_tpu.editor.ui``), on the CPU (``device='cpu'``).

Each case runs the same scenario on both packages and compares what it
observes; the cases mirror tests/test_editor_ui.py's where they apply
to the port:

- Scene models and controllers: one seeded script of gestures (drags
  with snapping, edge-handle trims, asset drags, z-order, zoom and
  scroll, undo and redo) on both packages. After every step the item
  views (rectangles, selection), the hit tests and handle hits at seeded
  points, the snap markers and the view transform are equal, and the
  ``!CanvasSpace`` documents are text-equal; undoing every entry and
  redoing it again keeps them equal.
- Ruler, painter, ``paint_timeline``: the u8 BGRA buffers are equal
  (tolerance 0), with and without thumbnails, with an expanded
  sequence (A/B roll).
- ``EditorApp``: open, save, new space, ``add_asset_to_space``; a
  project either editor saves opens in the other, the documents
  text-equal whichever editor module is imported first; the
  audio-master clock; ``RenderJob`` through ``write_video`` with
  ``CANVAS_AV_THREADS=1``: the u8 frames handed to the muxer equal.
- Widget shims through tests/fake_qt.py and fake_gtk.py, installed into
  each package's ``qt``/``gtk`` module as tests/test_editor_ui.py
  installs them into the JAX package's: presented pixels equal, the
  main window's surface, and ``python -m canvas_tpu_torch.editor``
  booting against the fake binding. A real toolkit runs only under the
  JAX package's skip conditions (tests/test_tk_widget.py,
  test_real_gtk_broadway.py, test_real_qt.py).

Every wait has a deadline (``DEADLINE``).
"""

import contextlib
import fractions
import json
import os
import runpy
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import fake_gtk
import fake_qt
from canvas_tpu import audio as ref_audio
from canvas_tpu import audioout as ref_audioout
from canvas_tpu import libav as ref_libav
from canvas_tpu import process as ref_process
from canvas_tpu import timecode as ref_timecode
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.editor import model as ref_model
from canvas_tpu.editor import plugins as ref_plugins
from canvas_tpu.editor import settings as ref_settings
from canvas_tpu.editor import ui as ref_ui
from canvas_tpu.editor.model import undo as ref_undo
from canvas_tpu.editor.ui import canvas_models as ref_canvas_models
from canvas_tpu.editor.ui import gtk as ref_gtk
from canvas_tpu.editor.ui import paint as ref_paint
from canvas_tpu.editor.ui import qt as ref_qt
from canvas_tpu.editor.ui import settings_models as ref_settings_models
from canvas_tpu_torch import audio as port_audio
from canvas_tpu_torch import audioout as port_audioout
from canvas_tpu_torch import libav as port_libav
from canvas_tpu_torch import process as port_process
from canvas_tpu_torch import timecode as port_timecode
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i as port_box2i
from canvas_tpu_torch.editor import model as port_model
from canvas_tpu_torch.editor import plugins as port_plugins
from canvas_tpu_torch.editor import settings as port_settings
from canvas_tpu_torch.editor import ui as port_ui
from canvas_tpu_torch.editor import yamlio
from canvas_tpu_torch.editor.model import undo as port_undo
from canvas_tpu_torch.editor.ui import canvas_models as port_canvas_models
from canvas_tpu_torch.editor.ui import gtk as port_gtk
from canvas_tpu_torch.editor.ui import gtk_ctypes as port_gtk_ctypes
from canvas_tpu_torch.editor.ui import paint as port_paint
from canvas_tpu_torch.editor.ui import qt as port_qt
from canvas_tpu_torch.editor.ui import settings_models as port_settings_models
from canvas_tpu_torch.editor.ui import tkui as port_tkui

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 10.0
SEED = 20261018

#: Each package's UI layer and what its scenarios build on. ``app_kw``:
#: the port's app renders on the CPU here.
REF = SimpleNamespace(
    name='ref', ui=ref_ui, model=ref_model, plugins=ref_plugins,
    process=ref_process, timecode=ref_timecode, box2i=ref_box2i,
    cm=ref_canvas_models, paint=ref_paint, qt=ref_qt, gtk=ref_gtk,
    undo=ref_undo, audio=ref_audio, audioout=ref_audioout, libav=ref_libav,
    settings=ref_settings, settings_models=ref_settings_models, app_kw={},
    dump=yaml.dump, load=lambda s: yaml.load(s, Loader=yaml.Loader))
PORT = SimpleNamespace(
    name='port', ui=port_ui, model=port_model, plugins=port_plugins,
    process=port_process, timecode=port_timecode, box2i=port_box2i,
    cm=port_canvas_models, paint=port_paint, qt=port_qt, gtk=port_gtk,
    undo=port_undo, audio=port_audio, audioout=port_audioout,
    libav=port_libav, settings=port_settings,
    settings_models=port_settings_models, app_kw={'device': 'cpu'},
    dump=yamlio.dump, load=yamlio.load)
BOTH = (PORT, REF)


def _wait(cond, budget=DEADLINE):
    deadline = time.time() + budget
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def _app(pkg, **kw):
    return pkg.ui.EditorApp(load_plugins=False, **dict(pkg.app_kw, **kw))


def _eq(a, b, path='result'):
    """Deep equality of scenario results: arrays by value and dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, '%s[%d]' % (path, i))
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _eq(a[k], b[k], '%s[%r]' % (path, k))
    else:
        assert a == b, (path, a, b)


def _both(scenario, *args):
    """Run *scenario(pkg, ...)* on each package; return the port's
    result after holding it equal to the JAX package's."""
    got, want = (scenario(pkg, *args) for pkg in BOTH)
    _eq(got, want)
    return got


def _runtime(pkg, name, color, rng=(0, 47), window=None):
    kw = {} if window is None else {'window': pkg.box2i(*window)}
    stream = pkg.plugins.VideoStream(
        pkg.process.SolidColorVideoSource(color, **kw), range=rng,
        name='video')
    return pkg.model.RuntimeSourceAsset(
        pkg.model.RuntimeSource(name, {'video': stream}))


@contextlib.contextmanager
def _fake_qt(pkg):
    old = pkg.qt._qt
    fake_qt.install(pkg.qt)
    try:
        yield
    finally:
        pkg.qt._qt = old
        fake_qt.QPainter.instances.clear()


def _image(widget):
    img = widget._image
    return np.frombuffer(img.data, np.uint8).reshape(img.height(),
                                                     img.width(), 4).copy()


# --- models (tests/test_editor_ui.py:22-414) ------------------------------

def test_ruler_model():
    def scenario(pkg):
        out = []
        for scale, left, width in ((2, 100, 200), (fractions.Fraction(1, 100),
                                                   0, 640),
                                   (fractions.Fraction(32, 10), 12.5, 320)):
            ruler = pkg.ui.TimeRulerModel(
                pkg.timecode.Frames(), scale=scale,
                frame_rate=fractions.Fraction(30, 1))
            ruler.set_left_frame(left)
            out.append((ruler.minor_tick, ruler.medium_tick,
                        ruler.major_tick, ruler.frame_at_x(20),
                        ruler.x_at_frame(10), ruler.ticks_in_width(width)))
        return out
    got = _both(scenario)
    assert got[0][3] == 110 and got[0][5]
    assert got[1][0] > got[0][0]            # zoomed out: coarser ticks
    assert any(t[1] == 'major' and t[2] for t in got[0][5])


def test_scene_model_and_hit_test():
    def scenario(pkg):
        vf = pkg.plugins.VideoFormat(frame_rate=1)
        af = pkg.plugins.AudioFormat(sample_rate=1)
        space = pkg.model.Space('s', vf, af)
        a = pkg.model.Clip(type='video', x=0, y=0.0, length=10, height=1.0)
        b = pkg.model.Clip(type='video', x=5, y=0.0, length=10, height=1.0)
        space[0:0] = [a, b]
        scene = pkg.ui.CanvasSceneModel(space)
        names = {id(a): 'a', id(b): 'b', id(None): None}
        hits = [names[id(scene.item_at(x, 0.5))] for x in (7.0, 12.0, 50.0)]
        scene.select([a])
        sel = [names[id(i)] for i in scene.selected_items]
        scene.select([b], extend=True)
        sel2 = sorted(names[id(i)] for i in scene.selected_items)
        return (scene.view_for(a).rect, hits, sel, sel2,
                scene.snap_x(10.1, exclude=()), scene.snap_x(30.0))
    got = _both(scenario)
    assert got == ((0.0, 0.0, 10.0, 1.0), ['a', 'b', None], ['a'],
                   ['a', 'b'], 10.0, 30.0)


def test_drag_controller_undo():
    def scenario(pkg):
        space = pkg.model.Space('s', pkg.plugins.VideoFormat(frame_rate=1),
                                pkg.plugins.AudioFormat(sample_rate=1))
        clip = pkg.model.Clip(type='video', x=0, y=0.0, length=10,
                              height=1.0)
        space[0:0] = [clip]
        scene = pkg.ui.CanvasSceneModel(space)
        stack = pkg.undo.UndoStack()
        drag = pkg.ui.DragController(scene, stack)
        xs = []
        drag.start(clip, 0.0, 0.0)
        drag.move_to_space(20.0, 1.0)
        xs.append(clip.x)
        drag.drop()
        stack.undo()
        xs.append(clip.x)
        stack.redo()
        xs.append(clip.x)
        drag.start(clip, 20.0, 1.0)
        drag.move_to_space(40.0, 0.0)
        xs.append(clip.x)
        drag.cancel()
        xs.append(clip.x)
        return xs, pkg.dump(space)
    assert _both(scenario)[0] == [20, 0, 20, 40, 20]


def test_handle_controller_clip_edges():
    """tests/test_editor_ui.py:94's gestures, the clip's geometry after
    each step equal in both packages (and as the JAX test asserts)."""
    def scenario(pkg):
        space = pkg.model.Space('s', pkg.plugins.VideoFormat(frame_rate=10),
                                pkg.plugins.AudioFormat(sample_rate=1))
        clip = pkg.model.Clip(type='video', x=10, y=0.0, length=20,
                              height=1.0, offset=5)
        space[0:0] = [clip]
        scene = pkg.ui.CanvasSceneModel(space)
        stack = pkg.undo.UndoStack()
        transform = pkg.cm.ViewTransformModel(pixels_per_second=100.0,
                                              pixels_per_lane=70.0)
        h = pkg.cm.HandleDragController(scene, stack, transform)
        trace = [[None if r is None else r[1] for r in (
            h.hit_test(x, y) for x, y in ((1.02, 0.5), (2.97, 0.5),
                                          (1.5, 0.03), (1.5, 0.97),
                                          (1.5, 0.5), (5.0, 0.5)))]]

        def geo():
            trace.append((clip.x, clip.offset, clip.length, clip.y,
                          clip.height))
        for edge, x0, y0, moves in (
                ('left', 1.0, 0.5, ((1.2, 0.5), (1.5, 0.5))),
                ('left', 1.0, 0.5, ((9.9, 0.5),)),
                ('right', 3.0, 0.5, ((0.0, 0.5), (4.0, 0.5))),
                ('top', 1.5, 0.0, ((1.5, 0.3), (1.5, 2.0))),
                ('bottom', 1.5, 1.0, ((1.5, 1.5),))):
            h.start(clip, edge, x0, y0)
            for mx, my in moves:
                h.move(mx, my)
                geo()
            h.drop()
            stack.undo()
            geo()
            stack.redo()
            geo()
            stack.undo()
            geo()
        h.start(clip, 'bottom', 1.5, 1.0)
        h.move(1.5, 1.5)
        h.cancel()
        geo()
        return trace
    trace = _both(scenario)
    assert trace[0] == ['left', 'right', 'top', 'bottom', None, None]
    assert trace[1][:3] == (12, 7, 18) and trace[2][:3] == (15, 10, 15)
    assert trace[-1] == (10, 5, 20, 0.0, 1.0)


def test_handle_controller_sequence_items():
    def scenario(pkg):
        m = pkg.model
        space = m.Space('s', pkg.plugins.VideoFormat(frame_rate=10),
                        pkg.plugins.AudioFormat(sample_rate=1))
        seq = m.Sequence(type='video', x=0, y=0.0, height=1.0,
                         expanded=True, items=[
                             m.SequenceItem(length=20, offset=3),
                             m.SequenceItem(length=20,
                                            transition_length=10)])
        space[0:0] = [seq]
        scene = pkg.ui.CanvasSceneModel(space)
        stack = pkg.undo.UndoStack()
        transform = pkg.cm.ViewTransformModel(pixels_per_second=10.0,
                                              pixels_per_lane=70.0)
        h = pkg.cm.HandleDragController(scene, stack, transform)
        hits = []
        for x, y in ((0.1, 0.2), (1.9, 0.2), (1.1, 0.8), (1.5, 0.5)):
            r = h.hit_test(x, y)
            hits.append(None if r is None else (list(seq).index(r[0]), r[1]))
        trace = [hits]
        h.start(seq[0], 'seq_left', 0.1, 0.2)
        h.move(0.5, 0.2)
        trace.append((seq[0].offset, seq[0].length, seq.x))
        h.drop()
        stack.undo()
        trace.append((seq[0].offset, seq[0].length, seq.x))
        h.start(seq[1], 'seq_right', 3.0, 0.8)
        h.move(2.5, 0.8)
        trace.append(seq[1].length)
        h.drop()
        stack.undo()
        trace.append(seq[1].length)
        trace.append(pkg.dump(space))
        return trace
    trace = _both(scenario)
    assert trace[:5] == [[(0, 'seq_left'), (0, 'seq_right'), (1, 'seq_left'),
                          None], (7, 16, 4), (3, 20, 0), 15, 20]


def test_alert_list_model():
    def scenario(pkg):
        pub = pkg.plugins.AlertPublisher()
        alerts = pkg.ui.AlertListModel(pub)
        a = pkg.plugins.Alert('one', key='1')
        b = pkg.plugins.Alert('two', key='2')
        rows = [len(alerts)]
        pub.show_alert(a)
        pub.show_alert(b)
        rows.append([alerts.row_text(i) for i in range(len(alerts))])
        pub.hide_alert(a)
        rows.append([alerts.row_text(i) for i in range(len(alerts))])
        return rows
    rows = _both(scenario)
    assert rows[0] == 0 and len(rows[1]) == 2 and 'two' in rows[2][0]


def test_view_transform_zoom_scroll_and_follow():
    def scenario(pkg):
        v = pkg.cm.ViewTransformModel(pixels_per_second=64.0)
        v.scroll_x = 2.0
        out = [v.view_to_scene(200.0, 0.0)]
        v.zoom(2, anchor_px=200.0)
        out.append((v.pixels_per_second, v.scroll_x,
                    v.view_to_scene(200.0, 0.0)))
        v.zoom(-2, anchor_px=200.0)
        v.scroll_by(33.0, 12.0)
        out.append((v.pixels_per_second, v.scroll_x, v.scroll_y))
        f = pkg.cm.ViewTransformModel(pixels_per_second=100.0)
        f.follow_playhead(0, 25, view_width_px=500)
        out.append(f.scroll_x)
        f.follow_playhead(1000, 25, view_width_px=500)
        out.append(f.scroll_x)
        return out
    out = _both(scenario)
    assert out[1][0] == pytest.approx(128.0)
    assert out[4] == pytest.approx(37.5)


def test_z_order_commands():
    def scenario(pkg):
        m = pkg.model
        space = m.Space('s', pkg.plugins.VideoFormat(frame_rate=1),
                        pkg.plugins.AudioFormat(sample_rate=1))
        a = m.Clip(type='video', x=0, y=0.0, length=5, height=1.0,
                   source=m.AssetStreamRef('red', 'video'), offset=0)
        b = m.Clip(type='video', x=2, y=0.0, length=5, height=1.0,
                   source=m.AssetStreamRef('green', 'video'), offset=0)
        space[0:0] = [a, b]
        out = [(a.z, b.z)]
        cmd = pkg.cm.z_order_commands([b], 'forward')
        cmd.redo()
        out.append((a.z, b.z, pkg.dump(space)))
        cmd.undo()
        out.append((a.z, b.z))
        both = pkg.cm.z_order_commands([a, b], 'back')
        both.redo()
        out.append((a.z, b.z, both.text()))
        out.append(pkg.cm.z_order_commands([], 'forward'))
        return out
    out = _both(scenario)
    assert out[0] == (0, 1) and out[1][:2] == (1, 0) and out[2] == (0, 1)


def test_settings_models(tmp_path):
    """The plugin and decoder editor models over each package's own
    plugins (the port's libav plugin and the JAX package's): the rows'
    shapes and the priority moves behave alike."""
    def scenario(pkg):
        pkg.settings.set_settings_path(str(tmp_path / (pkg.name + '.json')))
        pkg.plugins.PluginManager._reset_for_tests()
        try:
            pm = pkg.settings_models.PluginEditorModel()
            rows = pm.rows()
            names = [(r[1], r[3]) for r in rows]
            for (p, _n, _d, _e) in rows:
                pm.set_enabled(p, True)
            dm = pkg.settings_models.DecoderEditorModel()
            drows = dm.rows()
            first, second = drows[0][0], drows[1][0]
            dm.move_up(second)
            moved = dm.rows()[0][0] is second
            dm.move_down(second)
            back = dm.rows()[0][0] is first
            dm.set_enabled(first, False)
            off = not [r for r in dm.rows() if r[0] is first][0][3]
            return names, [(r[1], r[2]) for r in drows], moved, back, off
        finally:
            pkg.plugins.PluginManager._reset_for_tests()
            pkg.settings.set_settings_path(None)
    got, want = (scenario(pkg) for pkg in BOTH)
    assert got[2:] == want[2:] == (True, True, True)
    assert [n for n, _e in got[0]] == [n for n, _e in want[0]]
    assert len(got[1]) >= 2


# --- painter (tests/test_editor_ui.py:605-768) ----------------------------

def test_canvas_painter_pixels():
    def scenario(pkg):
        m = pkg.model
        space = m.Space('s', pkg.plugins.VideoFormat(frame_rate=10),
                        pkg.plugins.AudioFormat(sample_rate=48000))
        vclip = m.Clip(type='video', x=10, y=0.0, length=20, height=1.0)
        aclip = m.Clip(type='audio', x=24000, y=1.0, length=96000,
                       height=1.0)
        space[0:0] = [vclip, aclip]
        scene = pkg.ui.CanvasSceneModel(space)
        scene.select([vclip])
        transform = pkg.cm.ViewTransformModel(pixels_per_second=32.0,
                                              pixels_per_lane=30.0)
        transform.add_marker(pkg.cm.SnapMarker('x', 3.5))
        transform.add_marker(pkg.cm.SnapMarker('y', 2.5))
        ruler = pkg.ui.TimeRulerModel(pkg.timecode.Frames(),
                                      scale=fractions.Fraction(32, 10),
                                      frame_rate=fractions.Fraction(10, 1))
        painter = pkg.ui.CanvasPainter(scene, transform, ruler=ruler)
        bufs = [painter.paint(320, 120, playhead_frame=20, playhead_rate=10)]
        transform.scroll_by(64.0, 0.0)
        bufs.append(painter.paint(320, 120, playhead_frame=20,
                                  playhead_rate=10))
        bufs.append(pkg.ui.CanvasPainter(scene, transform).paint(97, 53))
        return bufs
    bufs = _both(scenario)
    theme = port_paint.THEME
    top = port_ui.CanvasPainter.ruler_height
    assert bufs[0].shape == (120, 320, 4) and bufs[0].dtype == np.uint8
    assert tuple(bufs[0][top + 12, 48]) == theme['clip_video']
    assert tuple(bufs[0][top + 12, 32]) == theme['selection']
    assert tuple(bufs[0][top + 40, 40]) == theme['clip_audio']
    assert tuple(bufs[0][5, 64]) == theme['playhead']
    assert tuple(bufs[1][5, 0]) == theme['playhead']


def test_canvas_painter_thumbnails():
    """Thumbnails blitted into video clips, scrolled so they crop at the
    viewport: equal buffers."""
    rng = np.random.default_rng(SEED)
    thumb = rng.integers(0, 256, (9, 16, 4), dtype=np.uint8)

    def scenario(pkg):
        m = pkg.model
        space = m.Space('s', pkg.plugins.VideoFormat(frame_rate=10),
                        pkg.plugins.AudioFormat(sample_rate=48000))
        a = m.Clip(type='video', x=0, y=0.0, length=40, height=1.0)
        b = m.Clip(type='video', x=30, y=1.0, length=25, height=1.5)
        space[0:0] = [a, b]
        scene = pkg.ui.CanvasSceneModel(space)
        transform = pkg.cm.ViewTransformModel(pixels_per_second=32.0,
                                              pixels_per_lane=40.0)
        ruler = pkg.ui.TimeRulerModel(pkg.timecode.Frames(),
                                      scale=fractions.Fraction(32, 10),
                                      frame_rate=fractions.Fraction(10, 1))
        painter = pkg.ui.CanvasPainter(scene, transform, ruler=ruler)
        thumbs = {a: thumb, b: thumb[::-1]}
        out = [painter.paint(200, 100, thumbnails=thumbs),
               painter.paint(200, 100)]
        transform.scroll_by(20.0, 15.0)
        out.append(painter.paint(200, 100, thumbnails=thumbs))
        return out
    bufs = _both(scenario)
    assert not np.array_equal(bufs[0], bufs[1])


def test_canvas_painter_expanded_sequence_ab_roll():
    def scenario(pkg):
        m = pkg.model
        space = m.Space('s', pkg.plugins.VideoFormat(frame_rate=10),
                        pkg.plugins.AudioFormat(sample_rate=48000))
        seq = m.Sequence(type='video', x=0, y=0.0, height=1.0,
                         expanded=True, items=[
                             m.SequenceItem(length=20),
                             m.SequenceItem(length=20, transition_length=10),
                             m.SequenceItem(length=20, transition_length=5)])
        space[0:0] = [seq]
        scene = pkg.ui.CanvasSceneModel(space)
        scene.select([seq])
        transform = pkg.cm.ViewTransformModel(pixels_per_second=10.0,
                                              pixels_per_lane=70.0)
        painter = pkg.ui.CanvasPainter(scene, transform)
        out = [painter.paint(500, 80)]
        seq.update(expanded=False)
        out.append(painter.paint(500, 80))
        seq.update(expanded=True)
        seq[3:3] = [m.SequenceItem(length=8)]
        out.append(painter.paint(500, 80))
        return out
    bufs = _both(scenario)
    theme = port_paint.THEME
    assert tuple(bufs[0][35, 15]) == theme['sequence_bg']
    assert tuple(bufs[1][35, 15]) == theme['clip_video']


def test_editor_paint_timeline():
    """SpaceEditor.paint_timeline: clips, ruler and the clock's playhead,
    with and without thumbnails, zoomed and scrolled."""
    thumb = np.random.default_rng(SEED + 1).integers(
        0, 256, (18, 32, 4), dtype=np.uint8)

    def scenario(pkg):
        app = _app(pkg)
        editor = app.new_space('paint', pkg.plugins.VideoFormat(frame_rate=10),
                               pkg.plugins.AudioFormat(sample_rate=48000))
        clip = pkg.model.Clip(type='video', x=10, y=0.0, length=20,
                              height=1.0)
        other = pkg.model.Clip(type='video', x=25, y=1.0, length=30,
                               height=1.0)
        editor.space[0:0] = [clip, other]
        app.seek(2 * 1_000_000_000)
        out = [editor.paint_timeline(320, 120)]
        transform = pkg.cm.ViewTransformModel(pixels_per_second=48.0)
        transform.zoom(1, anchor_px=100.0)
        transform.scroll_by(-30.0, 4.0)
        out.append(editor.paint_timeline(320, 120, transform=transform,
                                         thumbnails={clip: thumb}))
        return out
    bufs = _both(scenario)
    assert tuple(bufs[0][40, 100]) == port_paint.THEME['clip_video']
    assert tuple(bufs[0][2, 128]) == port_paint.THEME['playhead']


# --- the seeded gesture script ---------------------------------------------

GESTURES = 40


def _gesture_project(pkg):
    m = pkg.model
    space = m.Space('g', pkg.plugins.VideoFormat(
        full_frame=pkg.box2i(0, 0, 95, 63), frame_rate=fractions.Fraction(10)),
        pkg.plugins.AudioFormat(sample_rate=48000))
    ref = lambda name: m.AssetStreamRef(asset_path=name, stream='video')
    seq = m.Sequence(type='video', x=4, y=1.0, height=1.0, expanded=True,
                     items=[m.SequenceItem(source=ref('green'), offset=1,
                                           length=16),
                            m.SequenceItem(source=ref('blue'), offset=2,
                                           length=16, transition_length=4)])
    space[0:0] = [
        m.Clip(type='video', x=0, y=0.0, length=30, height=1.0,
               source=ref('red'), offset=0),
        m.Clip(type='video', x=12, y=0.0, length=20, height=1.0,
               source=ref('blue'), offset=3),
        seq,
        m.Clip(type='video', x=5, y=2.0, length=24, height=1.0,
               source=ref('red'), offset=0)]
    assets = m.AssetList()
    for name, color in (('red', (1, 0, 0, 1)), ('green', (0, 1, 0, 1)),
                        ('blue', (0, 0, 1, 0.5))):
        assets[name] = _runtime(pkg, name, color, rng=(0, 59))
    return space, assets


def _gesture_draws():
    """The script's numbers, drawn once from the seeded generator."""
    rng = np.random.default_rng(SEED)
    steps = []
    for _ in range(GESTURES):
        kind = ['drag', 'drag', 'handle', 'asset', 'zorder', 'view',
                'undo', 'redo'][int(rng.integers(0, 8))]
        steps.append((kind, rng.uniform(0, 1, 6).tolist(),
                      int(rng.integers(0, 4)), bool(rng.integers(0, 4))))
    probes = rng.uniform((0.0, -0.5), (6.0, 3.5), (24, 2)).tolist()
    return steps, probes


def _gesture_trace(pkg):
    steps, probes = _gesture_draws()
    space, assets = _gesture_project(pkg)
    scene = pkg.ui.CanvasSceneModel(space)
    stack = pkg.undo.UndoStack()
    transform = pkg.cm.ViewTransformModel(pixels_per_second=40.0,
                                          pixels_per_lane=30.0)
    drag = pkg.cm.DragController(scene, stack, transform=transform)
    handles = pkg.cm.HandleDragController(scene, stack, transform)
    assets_drag = pkg.cm.AssetDragController(scene, stack, assets)

    def name(item):
        if item is None:
            return None
        for i, it in enumerate(space):
            if it is item:
                return i
            if hasattr(it, '__len__'):
                for j, sub in enumerate(it):
                    if sub is item:
                        return (i, j)
        return repr(item)

    def observe():
        views = sorted((name(v.item), v.rect, v.selected,
                        None if v.sub_rects() is None else
                        [(name(s), r) for s, r in v.sub_rects()])
                       for v in scene.views.values())
        hits = [(name(scene.item_at(x, y)),
                 None if handles.hit_test(x, y) is None else
                 (name(handles.hit_test(x, y)[0]), handles.hit_test(x, y)[1]),
                 scene.snap_x(x))
                for x, y in probes]
        return (views, hits, [(mk.axis, mk.position)
                              for mk in transform.markers],
                (transform.pixels_per_second, transform.scroll_x,
                 transform.scroll_y), stack.index, stack.count(),
                pkg.dump(space))

    trace = [observe()]
    for kind, u, k, flag in steps:
        items = list(space)
        try:
            if kind == 'drag':
                item = items[k % len(items)]
                x, y, w, h = scene.view_for(item).rect
                scene.select([item])
                drag.start(item, x + w * u[0], y + h * 0.5)
                drag.move_to_space(u[1] * 6.0, u[2] * 3.0)
                drag.move_to_space(u[3] * 6.0, u[2] * 3.0)
                if flag:
                    drag.drop()
                else:
                    drag.cancel()
            elif kind == 'handle':
                item = items[k % len(items)]
                x, y, w, h = scene.view_for(item).rect
                edge = ('left', 'right', 'top', 'bottom')[int(u[0] * 4)]
                start = {'left': (x, y + h / 2), 'right': (x + w, y + h / 2),
                         'top': (x + w / 2, y),
                         'bottom': (x + w / 2, y + h)}[edge]
                if hasattr(item, '__len__') and edge in ('left', 'right'):
                    item, edge = item[0], 'seq_' + edge
                handles.start(item, edge, *start)
                handles.move(start[0] + (u[1] - 0.5) * 2.0,
                             start[1] + (u[2] - 0.5))
                if flag:
                    handles.drop()
                else:
                    handles.cancel()
            elif kind == 'asset':
                assert assets_drag.enter(('red', 'green', 'blue')[k % 3])
                assets_drag.move(u[1] * 5.0, u[2] * 3.0)
                if flag:
                    assets_drag.drop()
                else:
                    assets_drag.leave()
            elif kind == 'zorder':
                scene.select([it for i, it in enumerate(items)
                              if u[i % 6] > 0.5])
                command = pkg.cm.z_order_commands(
                    scene.selected_items, 'forward' if flag else 'back')
                if command is not None:
                    stack.push(command)
            elif kind == 'view':
                transform.zoom(int(u[0] * 4) - 2, anchor_px=u[1] * 300)
                transform.scroll_by((u[2] - 0.5) * 80, (u[3] - 0.5) * 20)
            elif kind == 'undo' and stack.can_undo():
                stack.undo()
            elif kind == 'redo' and stack.can_redo():
                stack.redo()
            outcome = 'ok'
        except Exception as exc:
            outcome = type(exc).__name__
        trace.append((kind, outcome, observe()))
    texts = []
    while stack.can_undo():
        stack.undo()
        texts.append(pkg.dump(space))
    while stack.can_redo():
        stack.redo()
        texts.append(pkg.dump(space))
    trace.append(texts)
    return trace


def test_gesture_script_matches_jax():
    """The seeded gesture script: after every step, views, hit tests,
    handle hits, snap positions, markers, the view transform, the undo
    stack and the !CanvasSpace document are equal; undo to the start
    and redo to the end again, text-equal after each."""
    trace = _both(_gesture_trace)
    kinds = [t[0] for t in trace[1:-1]]
    assert {'drag', 'handle', 'asset', 'zorder', 'view'} <= set(kinds)
    assert sum(t[1] == 'ok' for t in trace[1:-1]) >= GESTURES - 4
    assert len({t[2][-1] for t in trace[1:-1]}) >= 10   # the space changed
    undo_redo = trace[-1]
    n = len(undo_redo) // 2
    assert n >= 5
    assert undo_redo[n - 1] == trace[0][-1]               # back at start
    assert undo_redo[-1] == trace[-2][2][-1]              # at the end again


# --- EditorApp (tests/test_editor_ui.py:254-331, 1086-1145) ---------------

def test_editor_app_lifecycle(tmp_path):
    """Save, reopen, transport; the saved documents text-equal."""
    def scenario(pkg):
        app = _app(pkg)
        editor = app.new_space('test', pkg.plugins.VideoFormat(frame_rate=1),
                               pkg.plugins.AudioFormat(sample_rate=1))
        clip = pkg.model.Clip(type='video', x=2, y=0.0, length=8,
                              height=1.0,
                              source=pkg.model.AssetStreamRef('red', 'video'),
                              offset=0)
        editor.space[0:0] = [clip]
        path = str(tmp_path / ('%s.yaml' % pkg.name))
        app.save_file(path)
        with open(path) as f:
            text = f.read()
        app2 = _app(pkg)
        app2.open_file(path)
        editor2 = app2.open_space('test')
        got = (text, 'test' in app2.asset_list, len(editor2.space),
               editor2.space[0].x, editor2.space[0].source.asset_path)
        app2.play(1)
        speeds = [app2.clock.get_speed()]
        app2.stop()
        speeds.append(app2.clock.get_speed())
        return got, speeds
    got = _both(scenario)
    assert got[0][1:] == (True, 1, 2, 'red') and got[1] == [1, 0]


def test_add_asset_to_space():
    def scenario(pkg):
        app = _app(pkg)
        editor = app.new_space('comp', pkg.plugins.VideoFormat(frame_rate=1),
                               pkg.plugins.AudioFormat(sample_rate=1))
        app.asset_list['red'] = _runtime(pkg, 'red', (1, 0, 0, 1),
                                         rng=(0, 49))
        items = app.add_asset_to_space(editor, 'red', x=5, y=1.0)
        out = [len(items), pkg.dump(editor.space)]
        editor.undo_stack.undo()
        out.append(pkg.dump(editor.space))
        editor.undo_stack.redo()
        out.append(pkg.dump(editor.space))
        return out
    out = _both(scenario)
    assert out[0] == 1 and out[1] == out[3] != out[2]


SAVE_OPEN_SCRIPT = textwrap.dedent('''
    import os, sys, fractions
    order = sys.argv[1].split(',')
    tmp = sys.argv[2]
    apps = {}
    for name in order:
        if name == 'ref':
            from canvas_tpu.editor import model, plugins
            from canvas_tpu.editor.ui import EditorApp
            kw = {}
        else:
            from canvas_tpu_torch.editor import model, plugins
            from canvas_tpu_torch.editor.ui import EditorApp
            kw = {'device': 'cpu'}
        apps[name] = (EditorApp, model, plugins, kw)

    def build(name):
        EditorApp, model, plugins, kw = apps[name]
        app = EditorApp(load_plugins=False, **kw)
        ed = app.new_space('cut', plugins.VideoFormat(
            frame_rate=fractions.Fraction(25)),
            plugins.AudioFormat(sample_rate=48000))
        seq = model.Sequence(type='video', x=3, y=1.0, height=1.0, items=[
            model.SequenceItem(source=model.AssetStreamRef('red', 'video'),
                               offset=1, length=10),
            model.SequenceItem(source=model.AssetStreamRef('blue', 'video'),
                               offset=1, length=10, transition_length=5)])
        clip = model.Clip(type='video', x=0, y=0.0, length=12, height=1.0,
                          source=model.AssetStreamRef('red', 'video'),
                          offset=2)
        ed.undo_stack.push(model.InsertItemCommand(ed.space, clip, 0))
        ed.undo_stack.push(model.InsertItemCommand(ed.space, seq, 1))
        ed.undo_stack.push(model.MoveItemCommand(clip, x=7, y=2.0))
        return app

    texts = {}
    for name in order:
        app = build(name)
        path = os.path.join(tmp, name + '.yaml')
        app.save_file(path)
        texts[name] = open(path).read()
    assert texts['ref'] == texts['port'], (texts['ref'], texts['port'])
    # each opens the other's file and writes it out again unchanged
    for name, other in (('ref', 'port'), ('port', 'ref')):
        EditorApp, model, plugins, kw = apps[name]
        app = EditorApp(load_plugins=False, **kw)
        project = app.open_file(os.path.join(tmp, other + '.yaml'))
        ed = app.open_space('cut')
        assert type(ed.space) is model.Space, type(ed.space)
        assert [type(i).__name__ for i in ed.space] == ['Clip', 'Sequence']
        assert ed.space[0].x == 7 and len(ed.space[1]) == 2
        again = os.path.join(tmp, name + '-again.yaml')
        app.save_file(again)
        assert open(again).read() == texts[other]
    print('SAVE_OPEN_OK')
''')


@pytest.mark.parametrize('order', ['ref,port', 'port,ref'])
def test_projects_open_in_either_editor(tmp_path, order):
    """A project saved by the port's EditorApp opens in the JAX editor
    and the other way round, text-equal, whichever editor module the
    process imports first (fresh interpreters: PyYAML's registries are
    process-global)."""
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    env.setdefault('JAX_PLATFORMS', 'cpu')
    proc = subprocess.run(
        [sys.executable, '-c', SAVE_OPEN_SCRIPT, order, str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'SAVE_OPEN_OK' in proc.stdout


def test_open_file_uses_the_ports_loader_only(tmp_path, monkeypatch):
    """open_file/save_file go through yamlio's Loader and Dumper; PyYAML's
    global classes (the JAX editor's) are never asked."""
    app = _app(PORT)
    editor = app.new_space('s', port_plugins.VideoFormat(frame_rate=10),
                           port_plugins.AudioFormat(sample_rate=48000))
    editor.space[0:0] = [port_model.Clip(type='video', x=1, y=0.0,
                                         length=4, height=1.0)]
    calls = []
    real_load, real_dump = yaml.load, yaml.dump
    monkeypatch.setattr(yaml, 'load', lambda *a, **kw: calls.append(
        kw.get('Loader')) or real_load(*a, **kw))
    monkeypatch.setattr(yaml, 'dump', lambda *a, **kw: calls.append(
        kw.get('Dumper')) or real_dump(*a, **kw))
    path = str(tmp_path / 'p.yaml')
    app.save_file(path)
    project = _app(PORT).open_file(path)
    assert calls == [yamlio.Dumper, yamlio.Loader]
    assert type(project) is port_model.Project
    assert type(project.assets['s'].space) is port_model.Space


def test_editor_app_device():
    """The app renders on CUDA unless given a device and raises without
    one; its playback engines take the app's device."""
    if torch.cuda.is_available():
        assert port_ui.EditorApp(load_plugins=False).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            port_ui.EditorApp(load_plugins=False)
    app = _app(PORT)
    assert app.device == torch.device('cpu')
    editor = app.new_space('d', port_plugins.VideoFormat(frame_rate=10),
                           port_plugins.AudioFormat(sample_rate=48000))
    engine = editor.start_playback(lambda *a: None,
                                   port_box2i(0, 0, 15, 15))
    try:
        assert engine.device == torch.device('cpu')
    finally:
        engine.stop()


class _Capture:
    """An unpaced sink keeping every sample it is given."""

    def __init__(self):
        self.chunks = []

    @property
    def frames(self):
        return sum(len(c) for c in self.chunks)

    def write(self, samples):
        self.chunks.append(np.array(samples, copy=True))
        return len(samples)

    def delay(self):
        return 0

    def drop(self):
        pass

    def close(self):
        pass


def test_editor_audio_master_clock():
    """audio_master=True (tests/test_editor_ui.py:1086): the space's
    mixed audio feeds the sink and the clock follows it; the first 2048
    samples each sink receives are equal between the packages."""
    def scenario(pkg):
        sink = _Capture()
        app = _app(pkg, audio_master=True, audio_rate=8000,
                   audio_channels=2, audio_sink=sink)
        try:
            editor = app.new_space('am',
                                   pkg.plugins.VideoFormat(frame_rate=10),
                                   pkg.plugins.AudioFormat(sample_rate=8000))

            class Const(pkg.audio.AudioSource):
                def _render(self, frame):
                    n = np.arange(frame.full_min_sample,
                                  frame.full_max_sample + 1)
                    frame.data[:] = (0.5 + 0.001 * (n % 100))[:, None]
                    frame.current_min_sample = frame.full_min_sample
                    frame.current_max_sample = frame.full_max_sample

            stream = pkg.plugins.AudioStream(Const(), range=(0, 8000 * 60),
                                             name='audio')
            app.asset_list['tone'] = pkg.model.RuntimeSourceAsset(
                pkg.model.RuntimeSource('tone', {'audio': stream}))
            app.add_asset_to_space(editor, 'tone', x=0, length=8000 * 60)
            app.open_space('am')
            t0 = app.clock.get_presentation_time()
            app.play(1)
            assert _wait(lambda: sink.frames >= 2048)
            app.stop()
            assert app.clock.get_presentation_time() > t0
            return np.concatenate(sink.chunks)[:2048]
        finally:
            app.close()
    samples = _both(scenario)
    assert samples.shape == (2048, 2) and samples.min() >= 0.5


def test_audio_master_space_without_audio_and_replaced_project():
    """Under the audio clock a space's audio graph feeds the player;
    set_asset_list silences it; a space whose source has no audio
    stream opens harmlessly (StopIteration swallowed); close() joins the
    audio thread before the sink closes."""
    class VideoOnly:
        def __init__(self, space_asset):
            self.space = space_asset.space
            self._inner = space_asset.get_source()

        def get_source(self):
            return self

        def bring_online(self):
            self._inner.bring_online()

        def get_streams(self):
            return [s for s in self._inner.get_streams()
                    if s.stream_type == 'video']

    def scenario(pkg):
        sink = _Capture()
        closed = []
        app = _app(pkg, audio_master=True, audio_rate=8000, audio_sink=sink)
        sink.close = lambda: closed.append(app.clock._thread.is_alive())
        try:
            assets = pkg.model.AssetList()
            space = pkg.model.Space('s', pkg.plugins.VideoFormat(
                frame_rate=10), pkg.plugins.AudioFormat(sample_rate=8000))
            assets['s'] = pkg.model.SpaceAsset(space, name='s')
            app.set_asset_list(assets)
            app.open_space('s')
            fed = app.clock.source is not None
            app.set_asset_list({'v': VideoOnly(assets['s'])})
            silenced = app.clock.source is None
            editor = app.open_space('v')
            return fed, silenced, app.clock.source is None, \
                app.current_editor is editor
        finally:
            app.close()
            assert closed == [False]
    assert _both(scenario) == (True, True, True, True)


@pytest.fixture
def one_codec_thread(monkeypatch):
    monkeypatch.setenv('CANVAS_AV_THREADS', '1')


def _capture_muxer(lib, monkeypatch):
    got = []
    orig = lib.AVMuxer.write_video_frame

    def write(self, stream, frame):
        got.append(np.array(frame))
        return orig(self, stream, frame)

    monkeypatch.setattr(lib.AVMuxer, 'write_video_frame', write)
    return got


def test_render_job(tmp_path, monkeypatch, one_codec_thread):
    """RenderJob through each package's write_video: the same progress
    events and the same u8 frames handed to the muxer
    (tests/test_editor_ui.py:254)."""
    def scenario(pkg):
        frames = _capture_muxer(pkg.libav, monkeypatch)
        src = pkg.process.SolidColorVideoSource(pkg.process.LerpFunc(
            (0, 0, 0, 1), (1, 1, 1, 1), 20))
        path = str(tmp_path / ('%s.avi' % pkg.name))
        kw = dict(frame_size=(64, 48), frame_rate=25, video_codec='mpeg4',
                  bit_rate=500_000, batch=4, **pkg.app_kw)
        job = pkg.ui.RenderJob(path, src, None, 0, 20, **kw)
        events, done = [], []
        job.progress.connect(lambda d, total: events.append((d, total)))
        job.finished.connect(done.append)
        job.start()
        job.join(60)
        assert done == [None] and os.path.getsize(path) > 500
        return events, frames
    events, frames = _both(scenario)
    assert events[-1] == (20, 20) and len(frames) == 20


def test_render_job_device():
    """A RenderJob renders on CUDA unless given a device, and raises
    without a card."""
    if torch.cuda.is_available():
        assert port_ui.RenderJob('x.avi', None, None, 0, 1).device.type == \
            'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            port_ui.RenderJob('x.avi', None, None, 0, 1)
    with pytest.raises(ValueError):
        port_ui.RenderJob('x.avi', None, None, 0, 1, device='mps')
    job = port_ui.RenderJob('x.avi', None, None, 0, 1, device='cpu')
    assert job.device == torch.device('cpu')


# --- widget shims through the fake bindings -------------------------------

def test_thumbnail_painter():
    """tests/test_editor_ui.py:222 through each package's own queue: a
    red solid's thumbnails equal."""
    def scenario(pkg):
        kw = {'device': 'cpu'} if pkg is PORT else {}
        painter = pkg.ui.ThumbnailPainter(
            stream=pkg.process.SolidColorVideoSource((1.0, 0.0, 0.0, 1.0)),
            window=pkg.box2i(0, 0, 31, 31), size=(8, 8), count=3, **kw)
        try:
            painter.set_range(0, 30)
            ready = []
            painter.thumbnail_ready.connect(lambda s, b: ready.append(s))
            painter.request_all()
            assert _wait(lambda: len(ready) == 3)
            return sorted(ready), [painter.thumbnail(s) for s in range(3)]
        finally:
            painter._queue.close()
    slots, thumbs = _both(scenario)
    assert slots == [0, 1, 2] and thumbs[0][4, 4, 2] > 200


def _solid_widget_frame(pkg, make_widget, ready, image, color):
    clock = pkg.process.SystemPresentationClock()
    src = pkg.process.SolidColorVideoSource(color)
    widget = make_widget(src, clock)
    try:
        clock.play(1)
        assert _wait(lambda: ready(widget))
        clock.stop()
        return image(widget)
    finally:
        (widget.closeEvent(None) if hasattr(widget, 'closeEvent')
         else widget.close())


def test_qt_video_widget_with_fake_binding():
    """The Qt shim over each package's engine: PAR-scaled size hint and
    the presented ARGB32 image equal (tests/test_editor_ui.py:416)."""
    def scenario(pkg):
        with _fake_qt(pkg):
            assert pkg.qt.qt_available()
            hints = []

            def make(src, clock):
                widget = pkg.qt.VideoWidget(
                    src, clock, fractions.Fraction(30, 1),
                    pkg.box2i(0, 0, 31, 23), pixel_aspect_ratio=10.0 / 11.0,
                    **pkg.app_kw)
                hint = widget.sizeHint()
                hints.append((hint.width(), hint.height()))
                return widget
            img = _solid_widget_frame(pkg, make,
                                      lambda w: w._image is not None,
                                      _image, (0.2, 0.6, 0.9, 1.0))
            painted = [p for p in fake_qt.QPainter.instances if p.drawn]
            return hints, img, bool(painted)
    hints, img, painted = _both(scenario)
    assert hints == [(29, 24)] and painted and img.shape == (24, 32, 4)
    assert (img == img[0, 0]).all()
    b, g, r, a = (int(c) for c in img[0, 0])
    assert a == 255 and b > g > r


def test_qt_video_widget_device():
    """The port's Qt widget renders on the device it is given, CUDA by
    default (raising without a card)."""
    with _fake_qt(PORT):
        clock = port_process.SystemPresentationClock()
        src = port_process.SolidColorVideoSource((1, 1, 1, 1))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='CUDA'):
                port_qt.VideoWidget(src, clock, 30, port_box2i(0, 0, 7, 7))
        widget = port_qt.VideoWidget(src, clock, 30, port_box2i(0, 0, 7, 7),
                                     device='cpu')
        try:
            assert widget.engine.device == torch.device('cpu')
        finally:
            widget.closeEvent(None)


def test_gtk_video_widget_with_fake_binding():
    """The GTK shim over each package's engine: size request, pixbuf
    bytes and the size-allocate viewport equal
    (tests/test_editor_ui.py:538)."""
    def scenario(pkg):
        old = pkg.gtk._gtk
        fake_gtk.install(pkg.gtk)
        try:
            assert pkg.gtk.gtk_available()
            out = []

            def make(src, clock):
                widget = pkg.gtk.GtkVideoWidget(
                    src, clock, fractions.Fraction(30, 1),
                    pkg.box2i(0, 0, 31, 23), pixel_aspect_ratio=10.0 / 11.0,
                    **pkg.app_kw)
                out.append(widget.size_request)
                return widget

            def image(widget):
                pb = widget._pixbuf
                rgb = np.frombuffer(pb.data, np.uint8).reshape(
                    pb.height, pb.width, 3).copy()

                class Alloc:
                    width, height = 16, 12
                widget._size_allocate(widget, Alloc)
                vp = widget.engine._viewport
                Alloc.width, Alloc.height = 64, 48
                widget._size_allocate(widget, Alloc)
                return rgb, vp, widget.engine._viewport, \
                    widget.last_cr.painted[-1][0]
            out.append(_solid_widget_frame(
                pkg, make, lambda w: w._pixbuf is not None, image,
                (0.9, 0.3, 0.1, 1.0)))
            return out
        finally:
            pkg.gtk._gtk = old
            fake_gtk.Pixbuf.created.clear()
    size, (rgb, vp, vp2, painted) = _both(scenario)
    assert size == (29, 24) and vp == (16, 12) and vp2 is None
    assert painted == 'pixbuf' and (rgb == rgb[0, 0]).all()


def test_main_window_full_surface(tmp_path, one_codec_thread, monkeypatch):
    """The main window against the fake binding (tests/test_editor_ui.py
    :770): docks, menus, tabs, a mouse drag with undo/redo through the
    menu, alerts, transport, render_space; the timeline images, the
    undo dock's rows and the rendered frames equal."""
    def scenario(pkg):
        frames = _capture_muxer(pkg.libav, monkeypatch)
        with _fake_qt(pkg):
            app = _app(pkg)
            window = pkg.ui.create_main_window(app)
            try:
                out = [len(window.docks),
                       [m.title for m in window.menuBar().menus]]
                editor = window.new_space(
                    'cut', pkg.plugins.VideoFormat(frame_rate=24),
                    pkg.plugins.AudioFormat(sample_rate=48000))
                out.append(window.video_dock.widget is window.video_widget)
                app.asset_list['red'] = _runtime(pkg, 'red', (1, 0, 0, 1))
                out.append(list(window.asset_list_widget.items))
                app.add_asset_to_space(editor, 'red', x=0, length=24)
                (_e, widget) = window.editors['cut']
                widget.refresh()
                out.append(_image(widget))
                widget.mouse_press(32, 30)
                widget.mouse_move(160, 30)
                widget.mouse_release(160, 30)
                out.append((editor.space[0].x, _image(widget)))
                window.act_undo.triggered.emit()
                out.append(editor.space[0].x)
                window.act_redo.triggered.emit()
                out.append((editor.space[0].x,
                            list(window.undo_list_widget.items)))
                alert = pkg.plugins.Alert('disk full', key='df')
                app.alert_model.show_alert(alert)
                out.append(list(window.alert_list_widget.items))
                app.alert_model.hide_alert(alert)
                window.act_play.triggered.emit()
                speeds = [app.clock.get_speed()]
                window.act_stop.triggered.emit()
                window.act_rewind.triggered.emit()
                out.append((speeds, app.clock.get_speed(),
                            app.clock.get_presentation_time()))
                out.append(window.video_widget.engine.device.type
                           if pkg is PORT else 'cpu')
                path = str(tmp_path / ('%s.avi' % pkg.name))
                window.render_space(path, frame_size=(64, 48),
                                    video_codec='ffv1', format='avi')
                out.append((os.path.getsize(path) > 0, frames))
            finally:
                window.closeEvent(None)
            return out
    out = _both(scenario)
    assert out[0] == 4 and out[1] == ['&File', '&Edit', '&Tools']
    assert out[5][0] == 48 and out[6] == 0 and out[7][0] == 48
    assert out[10] == 'cpu' and out[11][0] and len(out[11][1]) == 72


def test_main_window_device():
    """create_main_window builds its app on *device*; a given app keeps
    its own, and a device that differs from it raises."""
    with _fake_qt(PORT):
        window = port_ui.create_main_window(device='cpu')
        try:
            assert window.app.device == torch.device('cpu')
        finally:
            window.closeEvent(None)
        app = _app(PORT)
        window = port_ui.create_main_window(app, device='cpu')
        window.closeEvent(None)
        if torch.cuda.is_available():
            with pytest.raises(ValueError):
                port_ui.create_main_window(app, device='cuda')


def _window_scenario(pkg, body):
    with _fake_qt(pkg):
        app = _app(pkg)
        window = pkg.ui.create_main_window(app)
        try:
            return body(pkg, app, window)
        finally:
            window.closeEvent(None)


def test_widget_asset_drop_and_edge_trim():
    """tests/test_editor_ui.py:912 and :962 on both packages: an asset
    dropped through the widget, a drag that leaves, a right-edge trim;
    the spaces' documents and the timeline images equal."""
    def body(pkg, app, window):
        editor = window.new_space('d', pkg.plugins.VideoFormat(frame_rate=24),
                                  pkg.plugins.AudioFormat(sample_rate=48000))
        app.asset_list['green'] = _runtime(pkg, 'green', (0, 1, 0, 1),
                                           rng=(0, 239))
        (_e, widget) = window.editors['d']
        widget.refresh()
        out = [widget.asset_drag_enter('green')]
        widget.asset_drag_move(128, 30)
        widget.asset_drop(128, 30)
        out.append(pkg.dump(editor.space))
        window.act_undo.triggered.emit()
        out.append(len(editor.space))
        window.act_redo.triggered.emit()
        assert widget.asset_drag_enter('green')
        widget.asset_drag_move(64, 30)
        out.append(len(editor.space))
        widget.asset_drag_leave()
        out.append(pkg.dump(editor.space))
        clip = editor.space[0]
        x0, _y, w, _h = editor.scene.view_for(clip).rect
        px = (x0 + w) * widget.transform.pixels_per_second - 2
        widget.mouse_press(px, 30)
        widget.mouse_move(px + 64, 30)
        widget.mouse_release(px + 64, 30)
        out.append((clip.length, _image(widget)))
        window.act_undo.triggered.emit()
        out.append((clip.length, pkg.dump(editor.space)))
        return out
    out = _both(_window_scenario, body)
    assert out[0] and out[2] == 0 and out[3] == 2
    assert out[5][0] == out[6][0] + 24


def test_menu_z_order_and_active_tab():
    """Bring forward / send back through the Edit menu and undo acting
    on the active tab (tests/test_editor_ui.py:1007, :1323)."""
    def body(pkg, app, window):
        vf = pkg.plugins.VideoFormat(frame_rate=24)
        af = pkg.plugins.AudioFormat(sample_rate=48000)
        ed_a = window.new_space('a', vf, af)
        ed_b = window.new_space('b', vf, af)
        out = [window.current_editor is ed_a]
        a = pkg.model.Clip(type='video', x=0, y=0.0, length=10, height=1.0)
        b = pkg.model.Clip(type='video', x=5, y=0.0, length=10, height=1.0)
        ed_a.space[0:0] = [a, b]
        ed_a.scene.select([b])
        window.act_bring_forward.triggered.emit()
        out.append((a.z, b.z))
        window.act_undo.triggered.emit()
        out.append((a.z, b.z))
        ed_a.scene.select([a])
        window.act_send_back.triggered.emit()
        out.append((a.z, b.z))
        window.document_tabs.setCurrentWidget(window.editors['b'][1])
        out.append(window.current_editor is ed_b)
        clip = pkg.model.Clip(type='video', x=5, y=0.0, length=10,
                              height=1.0)
        ed_b.space[0:0] = [clip]
        ed_b.undo_stack.push(pkg.model.MoveItemCommand(clip, x=9, y=0.0))
        window.act_undo.triggered.emit()
        out.append((clip.x, (a.z, b.z)))
        return out
    assert _both(_window_scenario, body) == [True, (1, 0), (0, 1), (1, 0),
                                             True, (5, (1, 0))]


def test_timeline_widget_thumbnails():
    """enable_thumbnails through each package's queue (the port's on the
    app's device): the timeline images with thumbnails equal
    (tests/test_editor_ui.py:1043)."""
    def body(pkg, app, window):
        editor = window.new_space('t', pkg.plugins.VideoFormat(frame_rate=24),
                                  pkg.plugins.AudioFormat(sample_rate=48000))
        app.asset_list['green'] = _runtime(pkg, 'green', (0.0, 1.0, 0.0, 1.0),
                                           rng=(0, 23), window=(0, 0, 63, 47))
        app.add_asset_to_space(editor, 'green', x=0, length=24)
        (_e, widget) = window.editors['t']
        widget.enable_thumbnails(window=pkg.box2i(0, 0, 63, 47))
        assert _wait(lambda: widget._thumbnail_map())
        device = widget._thumb_queue.device.type if pkg is PORT else 'cpu'
        widget.refresh()
        return device, _image(widget)
    device, buf = _both(_window_scenario, body)
    region = buf[26:40, 4:30]
    assert device == 'cpu'
    assert (region[..., 1].astype(int) - region[..., 2].astype(int)
            > 100).any()


def test_main_window_docks_follow_replaced_state(tmp_path):
    def body(pkg, app, window):
        editor = window.new_space('docks',
                                  pkg.plugins.VideoFormat(frame_rate=24),
                                  pkg.plugins.AudioFormat(sample_rate=48000))
        clip = pkg.model.Clip(type='video', x=0, y=0.0, length=5, height=1.0)
        editor.undo_stack.push(pkg.model.InsertItemCommand(editor.space,
                                                           clip, 0))
        out = [list(window.undo_list_widget.items)]
        path = str(tmp_path / ('%s.yaml' % pkg.name))
        app.save_file(path)
        app2 = _app(pkg)
        window2 = pkg.ui.create_main_window(app2)
        try:
            window2.open_project(path)
            app2.asset_list['late'] = _runtime(pkg, 'late', (1, 0, 0, 1))
            out.append(sorted(window2.asset_list_widget.items))
            out.append(sorted(window2.editors))
        finally:
            window2.closeEvent(None)
        return out
    out = _both(_window_scenario, body)
    assert out[0] and 'late' in out[1] and out[2] == ['docks']


def test_drag_clip_into_sequence_via_widget():
    """Clip dragged over a Sequence routes into sequence insertion, with
    the clip below or above the sequence in z (tests/test_editor_ui.py
    :1186, :1272)."""
    def body(pkg, app, window):
        out = []
        for clip_first in (False, True):
            name = 'seq%d' % clip_first
            editor = window.new_space(name,
                                      pkg.plugins.VideoFormat(frame_rate=10),
                                      pkg.plugins.AudioFormat(
                                          sample_rate=48000))
            app.asset_list['clip'] = _runtime(pkg, 'clip', (1, 0, 0, 1),
                                              rng=(0, 99))
            m = pkg.model
            ref = m.AssetStreamRef('clip', 'video')
            seq = m.Sequence(type='video', x=0, y=1.0, height=1.0, items=[
                m.SequenceItem(source=ref, length=15, offset=0),
                m.SequenceItem(source=ref, length=15, offset=0)])
            clip = m.Clip(type='video', x=0, y=1.0 if clip_first else 0.0,
                          length=10, height=1.0, source=ref)
            editor.space[0:0] = [clip, seq] if clip_first else [seq, clip]
            (_e, widget) = window.editors[name]
            y = 18 + 24 + 12 if clip_first else 18 + 10
            widget.mouse_press(16, y)
            widget.mouse_move(112, 18 + 24 + 12)
            widget.mouse_release(112, 18 + 24 + 12)
            out.append((len(seq), clip in list(editor.space),
                        pkg.dump(editor.space), _image(widget)))
            editor.undo_stack.undo()
            out.append((len(seq), pkg.dump(editor.space)))
        return out
    out = _both(_window_scenario, body)
    assert out[0][:2] == (3, False) and out[1][0] == 2
    assert out[2][:2] == (3, False)


def test_main_window_tools_menus(tmp_path):
    def body(pkg, app, window):
        pkg.settings.set_settings_path(str(tmp_path / (pkg.name + '.json')))
        try:
            window.act_edit_plugins.triggered.emit()
            window.act_edit_decoders.triggered.emit()
            return ([d.title for (_a, d) in window.docks],
                    hasattr(window, 'plugin_editor'),
                    hasattr(window, 'decoder_editor'))
        finally:
            pkg.settings.set_settings_path(None)
            pkg.plugins.PluginManager._reset_for_tests()
    names, pe, de = _both(_window_scenario, body)
    assert 'Plugins' in names and 'Decoders' in names and pe and de


def test_timeline_ruler_scrub_and_wheel_zoom():
    """Ruler scrubs drive the clock and the preview engine's quality;
    the wheel zooms about the cursor (tests/test_editor_ui.py:1395,
    :1442)."""
    def body(pkg, app, window):
        window.new_space('scrub', pkg.plugins.VideoFormat(frame_rate=24),
                         pkg.plugins.AudioFormat(sample_rate=48000))
        (editor, widget) = window.editors['scrub']
        engine = window.video_widget.engine
        out = []
        widget.mouse_press(128, 5)
        out.append((app.clock.get_presentation_time(), engine._quality))
        widget.mouse_move(192, 5)
        widget.mouse_release(192, 5)
        out.append((app.clock.get_presentation_time(), engine._quality))
        anchor = widget.transform.view_to_scene(100, 0)[0]
        widget.wheel(100, 1)
        out.append((widget.transform.pixels_per_second,
                    widget.transform.view_to_scene(100, 0)[0] - anchor,
                    _image(widget)))
        return out
    out = _both(_window_scenario, body)
    assert out[0] == (2_000_000_000, 4) and out[1] == (3_000_000_000, 10)


def test_drag_snaps_to_neighbor_edge():
    def scenario(pkg):
        m = pkg.model
        space = m.Space('s', pkg.plugins.VideoFormat(frame_rate=1),
                        pkg.plugins.AudioFormat(sample_rate=1))
        a = m.Clip(type='video', x=0, y=0.0, length=10, height=1.0)
        b = m.Clip(type='video', x=30, y=2.0, length=10, height=1.0)
        space[0:0] = [a, b]
        scene = pkg.ui.CanvasSceneModel(space)
        transform = pkg.cm.ViewTransformModel()
        drag = pkg.ui.DragController(scene, pkg.undo.UndoStack(),
                                     transform=transform)
        drag.start(b, grab_x_seconds=30.0, grab_y=2.0)
        drag.move_to_space(10.1, 2.0)
        out = [b.x, [(mk.axis, mk.position) for mk in transform.markers]]
        drag.drop()
        out.append(list(transform.markers))
        return out
    assert _both(scenario) == [10, [('x', 10.0)], []]


class _Pt:
    def __init__(self, x, y):
        self._x, self._y = x, y

    def x(self):
        return self._x

    def y(self):
        return self._y


class _Ev:
    """Stub Qt event; which position accessor exists is configurable."""

    def __init__(self, x=0, y=0, accessor='position', text=None,
                 source_item=None, wheel=None):
        self.accepted = False
        pt = _Pt(x, y)
        setattr(self, accessor, lambda: pt)
        if text is not None:
            md = type('MD', (), {'text': staticmethod(lambda: text)})
            self.mimeData = lambda: md
        if source_item is not None:
            item = type('It', (), {'text': staticmethod(lambda: source_item)})
            src = type('Src', (), {'currentItem': staticmethod(lambda: item)})
            self.source = lambda: src
        if wheel is not None:
            delta = _Pt(0, wheel)
            self.angleDelta = lambda: delta

    def acceptProposedAction(self):
        self.accepted = True


def test_widget_qt_event_adapters():
    """Qt events route to the toolkit-independent handlers alike
    (tests/test_editor_ui.py:1501)."""
    def body(pkg, app, window):
        editor = window.new_space('d', pkg.plugins.VideoFormat(frame_rate=24),
                                  pkg.plugins.AudioFormat(sample_rate=48000))
        app.asset_list['green'] = _runtime(pkg, 'green', (0, 1, 0, 1),
                                           rng=(0, 239))
        (_e, widget) = window.editors['d']
        out = []
        ev = _Ev(text='green')
        widget.dragEnterEvent(ev)
        out.append(ev.accepted)
        ev = _Ev(x=128, y=30, accessor='position')
        widget.dragMoveEvent(ev)
        out.append((ev.accepted, len(editor.space)))
        ev = _Ev(x=128, y=30, accessor='localPos')
        widget.dropEvent(ev)
        out.append((ev.accepted, editor.space[0].x))
        ev = _Ev(source_item='green')
        widget.dragEnterEvent(ev)
        widget.dragLeaveEvent(_Ev())
        out.append((ev.accepted, len(editor.space)))
        widget.wheelEvent(_Ev(x=100, accessor='pos', wheel=120))
        out.append(widget.transform.pixels_per_second)
        widget.mousePressEvent(_Ev(x=10, y=30))
        widget.mouseMoveEvent(_Ev(x=40, y=30))
        widget.mouseReleaseEvent(_Ev(x=40, y=30))
        out.append((pkg.dump(editor.space), _image(widget)))
        return out
    out = _both(_window_scenario, body)
    assert out[:4] == [True, (True, 1), (True, 48), (True, 1)]


def test_asset_search_dock_filters():
    def body(pkg, app, window):
        for name in ('Tape A', 'Tape B', 'Bars and tone'):
            app.asset_list[name] = _runtime(pkg, name, (0, 1, 0, 1))
        out = [sorted(window.asset_list_widget.items)]
        for text in ('tape', 'bars'):
            window.asset_search.setText(text)
            out.append(list(window.asset_list_widget.items))
        app.asset_list['More bars'] = _runtime(pkg, 'More bars',
                                               (0, 0, 1, 1))
        out.append(sorted(window.asset_list_widget.items))
        del app.asset_list['Bars and tone']
        out.append(list(window.asset_list_widget.items))
        window.asset_search.setText('')
        out.append(sorted(window.asset_list_widget.items))
        return out
    out = _both(_window_scenario, body)
    assert out[1] == ['Tape A', 'Tape B'] and out[-2] == ['More bars']


def test_main_window_async_render(tmp_path, one_codec_thread, monkeypatch):
    """File > Render on a RenderJob worker: progress, completion, a
    failure surfacing in the alert dock once flushed
    (tests/test_editor_ui.py:1595); the same frames reach each muxer."""
    def body(pkg, app, window):
        frames = _capture_muxer(pkg.libav, monkeypatch)
        editor = window.new_space('cut',
                                  pkg.plugins.VideoFormat(frame_rate=24),
                                  pkg.plugins.AudioFormat(sample_rate=48000))
        app.asset_list['green'] = _runtime(pkg, 'green', (0, 1, 0, 1))
        app.add_asset_to_space(editor, 'green', x=0, length=12)
        requested = []
        window.render_requested.connect(lambda: requested.append(1))
        window.act_render.triggered.emit()
        ticks, done = [], []
        window.render_progress.connect(lambda d, t: ticks.append((d, t)))
        window.render_finished.connect(done.append)
        job = window.render_space(str(tmp_path / ('%s.avi' % pkg.name)),
                                  block=False, frame_size=(64, 48),
                                  video_codec='ffv1', format='avi')
        job.join(timeout=60)
        out = [requested, list(done), ticks[-1], window._render_jobs == [],
               frames, job.device.type if pkg is PORT else 'cpu']
        done.clear()
        bad = window.render_space(str(tmp_path / 'nodir' / 'x.avi'),
                                  block=False, frame_size=(64, 48),
                                  video_codec='ffv1', format='avi')
        bad.join(timeout=60)
        out.append(len(done) == 1 and done[0] is not None)
        before = any('Render to' in t for t in window.alert_list_widget.items)
        window.flush_render_alerts()
        after = any('Render to' in t for t in window.alert_list_widget.items)
        out.append((before, after))
        return out
    out = _both(_window_scenario, body)
    assert out[0] == [1] and out[1] == [None] and out[2] == (12, 12)
    assert out[3] and len(out[4]) == 12 and out[5] == 'cpu'
    assert out[6] and out[7] == (False, True)


def _entry_point():
    """The port's ``python -m canvas_tpu_torch.editor`` module, run as a
    module (not as __main__) so main() can be called here."""
    return runpy.run_module('canvas_tpu_torch.editor.__main__',
                            run_name='canvas_tpu_torch_editor_entry')


def test_editor_entry_point_boots_against_fake_binding(tmp_path,
                                                       monkeypatch):
    """``python -m canvas_tpu_torch.editor PROJECT.yaml``'s main() opens a
    project the JAX editor saved, shows the window and tears down, with
    CANVAS_FORCE_CPU=1 rendering on the CPU (tests/test_editor_ui.py
    :1360)."""
    app = _app(REF)
    editor = app.new_space('cut', ref_plugins.VideoFormat(frame_rate=24),
                           ref_plugins.AudioFormat(sample_rate=48000))
    editor.space[0:0] = [ref_model.Clip(type='video', x=2, y=0.0, length=10,
                                        height=1.0)]
    path = str(tmp_path / 'p.yaml')
    app.save_file(path)
    monkeypatch.setenv('CANVAS_FORCE_CPU', '1')
    made = []
    real = port_ui.create_main_window

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(port_ui, 'create_main_window', spy)
    mod = _entry_point()
    with _fake_qt(PORT):
        rc = mod['main'](['editor', path])
    assert rc == 0
    (window,) = made
    assert window.app.device == torch.device('cpu')
    assert sorted(window.editors) == ['cut']
    assert window.editors['cut'][0].space[0].x == 2


def test_editor_entry_point_without_qt(capsys):
    """No Qt binding: the same two lines as scripts/editor.py, exit 1."""
    old = port_qt._qt
    port_qt._qt = False
    try:
        rc = _entry_point()['main'](['editor'])
    finally:
        port_qt._qt = old
    out = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert out == ['No Qt binding (PyQt5/PyQt6/PySide6) installed.',
                   'The editor logic still runs headless — see '
                   'canvas_tpu_torch.editor.ui.EditorApp and the test suite.']


def test_editor_entry_point_render_dialog_wiring(tmp_path, one_codec_thread):
    """The entry point's File > Render wiring against the fake binding:
    cancel at the dialog starts nothing; a path runs the async job and
    the GUI timer reports completion (tests/test_editor_ui.py:1659)."""
    mod = _entry_point()
    with _fake_qt(PORT):
        app = _app(PORT)
        window = port_ui.create_main_window(app)
        try:
            editor = window.new_space(
                'cut', port_plugins.VideoFormat(
                    frame_rate=24, full_frame=port_box2i(0, 0, 63, 47)),
                port_plugins.AudioFormat(sample_rate=48000))
            app.asset_list['blue'] = _runtime(PORT, 'blue', (0, 0, 1, 1))
            app.add_asset_to_space(editor, 'blue', x=0, length=10)
            mod['_wire_render_dialog'](window, fake_qt.QtWidgetsModule,
                                       fake_qt.QtCoreModule)
            (timer,) = [t for t in fake_qt.QTimer.instances
                        if t.parent is window]
            fake_qt.QFileDialog.next_path = ''
            window.act_render.triggered.emit()
            assert not timer.active and window._render_jobs == []
            out = str(tmp_path / 'cut.avi')
            fake_qt.QFileDialog.next_path = out
            window.act_render.triggered.emit()
            assert timer.active
            (job,) = window._render_jobs
            job.join(timeout=60)
            timer.timeout.emit()
            assert not timer.active and os.path.getsize(out) > 0
            assert any('Render complete' in m
                       for m, _t in window.statusBar().messages)
        finally:
            window.closeEvent(None)
            fake_qt.QTimer.instances.clear()
            fake_qt.QFileDialog.next_path = ''


def test_editor_app_end_to_end_playback():
    """Project -> drag-edit -> playback through the fake-Qt widget over
    the compiled graph (tests/test_editor_ui.py:480): the presented
    frames equal."""
    def scenario(pkg):
        app = _app(pkg)
        editor = app.new_space('e2e', pkg.plugins.VideoFormat(frame_rate=24),
                               pkg.plugins.AudioFormat(sample_rate=48000))
        app.asset_list['card'] = _runtime(pkg, 'card', (0.8, 0.2, 0.1, 1.0),
                                          rng=(0, 11))
        app.add_asset_to_space(editor, 'card', x=0, length=12)
        with _fake_qt(pkg):
            widget = pkg.qt.VideoWidget(
                editor.video_stream, app.clock, fractions.Fraction(24, 1),
                pkg.box2i(0, 0, 47, 31), **pkg.app_kw)
            try:
                app.play(1)
                assert _wait(lambda: widget._image is not None)
                app.stop()
                return _image(widget)
            finally:
                widget.closeEvent(None)
    bgra = _both(scenario)
    assert bgra[16, 24, 2] > bgra[16, 24, 0]


def test_editor_session_under_the_audio_clock():
    """The editor's headline project at 96x64 under the audio-master
    clock (chip_smoke.py phase 14a in small, on the CPU): the engine
    presents increasing frames while a NullSink consumes samples in real
    time, and a presented frame equals the JAX engine's for the same
    frame of the same project."""
    from canvas_tpu import playback as ref_playback
    from test_torch_editor_graph import _ref_video, ref_editor_headline
    window = (880, 640, 975, 703)
    sink = port_audioout.NullSink(48000)
    app = _app(PORT, audio_master=True, audio_rate=48000, audio_channels=2,
               audio_sink=sink)
    shown = {}
    engine = None
    try:
        assets, _space = timelines.editor_headline(64)
        app.set_asset_list(assets)
        editor = app.open_space('headline')
        t0 = app.clock.get_presentation_time()
        engine = editor.start_playback(
            lambda i, f: shown.__setitem__(i, f.copy()),
            port_box2i(*window), batch=4)
        engine.warm(0)
        app.play(1)
        time.sleep(1.0)
        app.stop()
        advanced = app.clock.get_presentation_time() - t0
    finally:
        if engine is not None:
            engine.stop()
        app.close()
    order = sorted(shown)
    assert len(order) >= 5 and order[-1] >= 10, order
    assert 0.5e9 < advanced < 2e9
    ref = ref_playback.VideoPlaybackEngine(
        _ref_video(ref_editor_headline(64)[1]),
        ref_process.SystemPresentationClock(), fractions.Fraction(25),
        ref_box2i(*window), lambda i, f: shown.__setitem__(('ref', i), f))
    try:
        ref.display_frame(order[-1])
    finally:
        ref.stop()
    np.testing.assert_array_equal(shown[order[-1]], shown[('ref', order[-1])])


# --- real toolkits, under the JAX package's skip conditions ----------------

def test_bgra_to_ppm_equal():
    rng = np.random.default_rng(5)
    bgra = rng.integers(0, 256, (4, 5, 4), dtype=np.uint8)
    from canvas_tpu.editor.ui import tkui as ref_tkui
    assert port_tkui.bgra_to_ppm(bgra) == ref_tkui.bgra_to_ppm(bgra)
    assert port_tkui.bgra_to_ppm(bgra[:, ::-1]) == \
        ref_tkui.bgra_to_ppm(bgra[:, ::-1])


@pytest.mark.skipif(not port_tkui.tk_available(),
                    reason='no display for tkinter (headless); the widget '
                           'logic is covered by the PPM test and the '
                           'shared playback engine')
def test_tk_widget_blits_real_pixels():
    import tkinter
    ws = port_process.VideoWorkspace()
    ws.add(source=port_process.SolidColorVideoSource((1.0, 0.0, 0.0, 1.0)),
           x=0, length=48, z=0)
    clock = port_process.SystemPresentationClock()
    root = tkinter.Tk()
    try:
        widget = port_tkui.VideoWidget(ws, clock, fractions.Fraction(24),
                                       port_box2i(0, 0, 159, 119),
                                       master=root, device='cpu')
        widget.pack()
        widget.engine.warm(0)
        clock.seek(0)
        deadline = time.time() + 30
        while widget._photo is None and time.time() < deadline:
            root.update()
            time.sleep(0.01)
        assert widget._photo is not None
        r, g, b = widget._photo.get(10, 10)
        assert r > 150 and g < 60 and b < 60
    finally:
        root.destroy()


needs_broadway = pytest.mark.skipif(
    not port_gtk_ctypes.broadway_available(),
    reason='broadwayd or GTK 3 libraries not present')


def _gtk_selftest(*args):
    env = dict(os.environ)
    env.pop('GDK_BACKEND', None)
    env.pop('BROADWAY_DISPLAY', None)
    out = subprocess.run(
        [sys.executable, '-m', 'canvas_tpu_torch.editor.ui.gtk_ctypes']
        + list(args), capture_output=True, text=True, timeout=180, env=env,
        cwd=REPO)
    assert out.returncode == 0, (out.stdout, out.stderr)
    return json.loads(out.stdout.strip().splitlines()[-1])


@needs_broadway
def test_real_gtk_paints_engine_frame():
    """The port's engine (on the CPU) -> a real GTK draw signal -> the
    realized window's pixels (tests/test_real_gtk_broadway.py)."""
    got = _gtk_selftest('--device', 'cpu')
    assert got['ok_paint'] and got['painted'] >= 1
    assert got['center_rgb'] == [0, 255, 0], got
    assert got['frame_index'] == 0


@needs_broadway
def test_real_gtk_paints_timeline_rasterizer():
    got = _gtk_selftest('--paint')
    assert got['painted'] >= 1 and got['match'], got


def _real_qt_binding():
    import importlib
    for name in ('PyQt6', 'PyQt5', 'PySide6'):
        try:
            return tuple(importlib.import_module(name + mod) for mod in
                         ('.QtWidgets', '.QtGui', '.QtCore'))
        except ImportError:
            continue
    return None


@pytest.mark.skipif(_real_qt_binding() is None,
                    reason='no real Qt binding installed (PyQt6/PyQt5/'
                           'PySide6); the fake-binding cases cover the '
                           'widget logic')
def test_main_window_offscreen_smoke():
    """tests/test_real_qt.py's main window smoke on the port."""
    os.environ.setdefault('QT_QPA_PLATFORM', 'offscreen')
    binding = _real_qt_binding()
    qapp = binding[0].QApplication.instance() or \
        binding[0].QApplication([sys.argv[0]])
    app = _app(PORT)
    window = port_ui.create_main_window(app, binding=binding)
    try:
        editor = window.new_space('smoke',
                                  port_plugins.VideoFormat(frame_rate=24),
                                  port_plugins.AudioFormat(sample_rate=48000))
        app.asset_list['red'] = _runtime(PORT, 'red', (0.9, 0.2, 0.1, 1.0))
        app.add_asset_to_space(editor, 'red', x=0, length=24)
        (_e, widget) = window.editors['smoke']
        widget.resize(320, 120)
        widget.refresh()
        qapp.processEvents()
        image = widget.grab().toImage()
        assert image.width() > 0 and image.height() > 0
    finally:
        window.closeEvent(None)
