"""The port's editor graph (canvas_tpu_torch.editor.graph: the managers
that turn a Space and its Sequences into the port's sources) against the
JAX package's, on the CPU.

- Plans param for param (as tests/test_torch_host.py holds the
  timelines'): the same segments, sliced signatures, flat params
  (staged stacks by content) and per-node windows, for
  ``timelines.editor_headline`` and ``timelines.editor_cut`` beside the
  same projects built from the JAX package's classes, and for the
  project of tests/test_torch_editor_model.py after every step of its
  32-edit script, which also fires the same ``frames_updated`` ranges
  in both packages.
- Frames: the solid projects (the headline project, the script's
  project before and after the script) bit-equal to
  ``canvas_tpu.render``'s program; the DV cut within 1 f16 ulp on
  99.99% of values (the mixed timeline's tolerance: the DV chroma
  matmul and the scalers sum in another order) and against the NumPy
  pull path.
- ``editor_headline`` plans the headline's signature and renders its
  frames bit for bit; an edit's ranged ``frames_updated`` reaches the
  port's plan cache (the port's copy of the JAX editor's
  ``test_edit_ranged_invalidation_reaches_planner``).
"""

import fractions

import numpy as np
import pytest
import torch

import bench
import benchmarks
from canvas_tpu import render as ref_render
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.editor.graph.video import SpaceVideoManager as RefManager
from canvas_tpu_torch import ir, timelines
from canvas_tpu_torch import render as port
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.editor import graph as port_graph
from canvas_tpu_torch.editor import plugins as port_plugins
from test_torch_editor_model import (PORT, REF, SCRIPT, make_assets,
                                     start_state)

#: 96x64 windows that see every layer a project shows there: the
#: headline's cards, crossfade and (from frame ~20) scalers; the cut's
#: background and its first two DV clips.
W_HEAD = (880, 640, 975, 703)
W_CUT = (640, 120, 735, 183)
W_SCRIPT = (0, 0, 95, 63)


def _walk(node, out=None):
    out = [] if out is None else out
    out.append(node)
    for c in node.children:
        _walk(c, out)
    return out


def _ulps_f16(a, b):
    """Distance of two arrays on the f16 grid, in f16 steps."""
    def order(x):
        bits = x.astype(np.float16).view(np.int16).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7fff), bits)
    return np.abs(order(a) - order(b))


# --- the JAX package's editor projects, item for item ----------------------

def _ref_project(name, clips, assets):
    space = REF.model.Space(name, REF.plugins.VideoFormat(
        full_frame=ref_box2i(0, 0, 1919, 1079),
        frame_rate=fractions.Fraction(25)),
        REF.plugins.AudioFormat(sample_rate=48000,
                                channel_assignment=['FrontLeft',
                                                    'FrontRight']))
    space[:] = clips
    assets[name] = REF.model.SpaceAsset(space, name=name)
    return assets, assets[name]


def _ref_asset(assets, name, source):
    stream = REF.plugins.VideoStream(source, None, name='video')
    assets[name] = REF.model.RuntimeSourceAsset(
        REF.model.RuntimeSource(name, {'video': stream}))
    return REF.model.AssetStreamRef(asset_path=name, stream='video')


def ref_editor_headline(length):
    assets = REF.model.AssetList()
    clips = []
    for item in sorted(bench.build_timeline(length), key=lambda it: it.z):
        ref = _ref_asset(assets, timelines.EDITOR_LAYERS[item.z],
                         item.source)
        clips.append(REF.model.Clip(type='video', source=ref,
                                    offset=item.offset, x=item.x,
                                    y=float(9 - item.z), length=item.length,
                                    height=1.0))
    return _ref_project('headline', clips, assets)


def ref_editor_cut(length):
    from canvas_tpu import process
    assets = REF.model.AssetList()
    background = _ref_asset(assets, 'background',
                            process.SolidColorVideoSource(
                                (0.1, 0.1, 0.12, 1.0)))
    strip = _ref_asset(assets, 'strip', process.SolidColorVideoSource(
        (1, 1, 1, 0.08), window=ref_box2i(0, 980, 1919, 1079)))
    mixed = benchmarks._mixed_timeline(length)
    items = []
    for i, z in enumerate((2, 4, 6)):
        source = [it for it in mixed if it.z == z][0].source
        ref = _ref_asset(assets, 'dv%d' % i, source)
        items.append(REF.model.SequenceItem(
            source=ref, offset=0, length=timelines.CUT_CLIP,
            transition_length=timelines.CUT_TRANSITION if i else 0))
    clips = [
        REF.model.Clip(type='video', source=background, x=0, y=2.0,
                       length=length, height=1.0),
        REF.model.Sequence(type='video', items=items, x=0, y=1.0,
                           height=1.0),
        REF.model.Clip(type='video', source=strip, x=0, y=0.0,
                       length=length, height=1.0),
    ]
    return _ref_project('cut', clips, assets)


def _ref_video(space_asset):
    source = space_asset.get_source()
    source.bring_online()
    return source.get_stream('Video')


@pytest.fixture(scope='module')
def projects():
    """name -> (the JAX package's video stream, the port's)."""
    out = {}
    for name, ref_make, port_make, n in (
            ('headline', ref_editor_headline, timelines.editor_headline, 64),
            ('cut', ref_editor_cut, timelines.editor_cut, 256)):
        out[name] = (_ref_video(ref_make(n)[1]),
                     timelines.editor_video(port_make(n)[1]))
    return out


def assert_plans_equal(ref_src, port_src, window, start, stop):
    """Both packages plan [start, stop) of their own source at *window*:
    the same segments, and in each the same sliced signature, every flat
    param equal with its dtype (a staged stack by content) and the same
    per-node windows. Returns the segments."""
    rp = ref_render.RenderPlanner(ref_src, ref_box2i(*window))
    pp = port.RenderPlanner(port_src, box2i(*window), device='cpu')
    rp.stage_cache_mb = pp.stage_cache_mb = 0
    segs = pp.segments(start, stop)
    assert segs == rp.segments(start, stop)
    for seg in segs:
        N = seg[1] - seg[0]
        rp._stage_cache, rp._frame_hints = {}, {}
        ref = ref_render.PlanContext(rp, np.arange(*seg),
                                     rp.window).plan(ref_src)
        got = pp._plan(seg)
        for B in sorted({N, 2}):
            assert (port.sliced_signature(got, N, B)
                    == ref_render._sliced_signature(ref, N, B)), seg
        for p, q in zip(port.flat_params(got), ref.flat_params([])):
            assert sorted(p) == sorted(q)
            for k in q:
                v = p[k].numpy() if isinstance(p[k], torch.Tensor) else p[k]
                w = np.asarray(q[k])
                assert v.dtype == w.dtype and np.array_equal(v, w), (seg, k)
        for a, b in zip(_walk(got), _walk(ref)):
            assert a.op == b.op
            np.testing.assert_array_equal(
                ir.windows_to_array(a.windows),
                ref_render.windows_to_array(b.windows))
    pp.close()
    return segs


def _render_both(ref_src, port_src, window, start, stop):
    want = np.asarray(ref_render.render_frames(ref_src, ref_box2i(*window),
                                               start, stop))
    planner = port.RenderPlanner(port_src, box2i(*window), device='cpu')
    got = planner.render(start, stop)
    planner.close()
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape
    return got, want


# --- the two projects --------------------------------------------------------

@pytest.mark.parametrize('name, window, start, stop', [
    ('headline', W_HEAD, 0, 20),
    ('headline', (0, 0, 319, 179), 0, 4),
    ('cut', W_CUT, 40, 70),
    ('cut', W_CUT, 100, 120),
    ('cut', (0, 0, 319, 179), 160, 176),
])
def test_project_plans_match_jax(projects, name, window, start, stop):
    ref_src, port_src = projects[name]
    assert_plans_equal(ref_src, port_src, window, start, stop)


def test_headline_project_signature_is_the_headlines():
    """At full size the editor's headline project plans the signature of
    build_timeline (the port's and bench.py's) on every segment."""
    full = box2i(0, 0, 1919, 1079)
    ed = port.RenderPlanner(timelines.editor_video(
        timelines.editor_headline(64)[1]), full, device='cpu')
    hd = port.RenderPlanner(timelines.build_timeline(64), full,
                            device='cpu')
    rp = ref_render.RenderPlanner(bench.build_timeline(64),
                                  ref_box2i(0, 0, 1919, 1079))
    segs = ed.segments(0, 64)
    assert segs == hd.segments(0, 64) == rp.segments(0, 64)
    for seg in segs:
        sig = port.signature(ed._plan(seg))
        assert sig == port.signature(hd._plan(seg))
        rp._stage_cache, rp._frame_hints = {}, {}
        assert sig == ref_render.PlanContext(
            rp, np.arange(*seg), rp.window).plan(rp.source).signature()
    ed.close()
    hd.close()


def test_headline_project_frames_bit_equal(projects):
    ref_src, port_src = projects['headline']
    got, want = _render_both(ref_src, port_src, W_HEAD, 12, 28)
    np.testing.assert_array_equal(got, want)
    head = port.RenderPlanner(timelines.build_timeline(64), box2i(*W_HEAD),
                              device='cpu')
    np.testing.assert_array_equal(got, head.render(12, 28))
    head.close()
    assert got[:, 3].min() > 0 and np.unique(got[:, 0]).size > 4


@pytest.mark.parametrize('start, stop', [(48, 64), (100, 116)])
def test_cut_frames_match_jax_and_pull(projects, start, stop):
    """The crossfades (frames 52..63 and 104..115) included. Against the
    pull path the port is held where the JAX package is: its pull is the
    JAX package's bit for bit, and its batched frames agree with it on
    at least the share of values the JAX package's own do (inside a
    scaled DV clip, ~97%: the scalers round otherwise), within 1e-2."""
    ref_src, port_src = projects['cut']
    got, want = _render_both(ref_src, port_src, W_CUT, start, stop)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=4e-3)
    assert np.mean(_ulps_f16(got, want) <= 1) >= 0.9999
    for f in (start + 2, start + 10):
        pull = np.asarray(port_src.get_frame_f16(f, box2i(*W_CUT)).data,
                          np.float16)
        ref_pull = np.asarray(ref_src.get_frame_f16(
            f, ref_box2i(*W_CUT)).data, np.float16)
        np.testing.assert_array_equal(pull, ref_pull)
        np.testing.assert_allclose(got[f - start].astype(np.float32),
                                   pull.astype(np.float32), rtol=0,
                                   atol=1e-2)
        assert (np.mean(got[f - start] == pull)
                >= np.mean(want[f - start] == ref_pull) - 1e-3)


def test_cut_reaches_region_over_and_dv_staging():
    """At full size the cut plans its DV clips as a placed region that is
    not a factored solid (``region_over`` on the card) over staged DV
    rows between the two solids (``solid_fold``), and its crossfade as a
    mix of two such clips."""
    src = timelines.editor_video(timelines.editor_cut(256)[1])
    planner = port.RenderPlanner(src, box2i(0, 0, 1919, 1079), device='cpu')
    for seg, region, n_dv in (((0, 53), 'scale_taps_dyn', 1),
                              ((53, 64), 'mix', 2)):
        node = planner._plan(seg)
        assert node.op == 'over_stack'
        assert [c.op for c in node.children] == ['solid', 'placed', 'solid']
        assert node.children[1].children[0].op == region
        assert [n.op for n in _walk(node)].count('dv_recon_rows') == n_dv
    planner.close()


# --- the 32-edit script --------------------------------------------------------

def _managers():
    """Each package's script state and its SpaceVideoManager, recording
    the manager's frames_updated ranges."""
    out = {}
    for key, pkg, make in (('ref', REF, RefManager),
                           ('port', PORT, port_graph.SpaceVideoManager)):
        st = start_state(pkg)
        assets = make_assets(pkg)
        manager = make(st['space'], assets)
        fired = []
        manager.frames_updated.connect(
            lambda *a, fired=fired: fired.append(tuple(a[-2:])))
        out[key] = (st, manager, fired)
    return out


def test_script_plans_and_ranges_match_jax():
    """After every edit of the script both packages plan the edited
    project alike, and each edit fired the same ranges."""
    m = _managers()
    assert_plans_equal(m['ref'][1], m['port'][1], W_SCRIPT, 0, 64)
    silent = []
    for i, (name, step) in enumerate(SCRIPT):
        for key, pkg in (('ref', REF), ('port', PORT)):
            m[key][2].clear()
            step(pkg, m[key][0])
        assert m['port'][2] == m['ref'][2], (i, name)
        if not m['port'][2]:
            silent.append(name)
        assert_plans_equal(m['ref'][1], m['port'][1], W_SCRIPT, 0, 64)
    # a clip's height changes no pixel: nothing to invalidate
    assert silent == ['height C']


def test_script_frames_bit_equal_before_and_after():
    m = _managers()
    before, want = _render_both(m['ref'][1], m['port'][1], W_SCRIPT, 0, 48)
    np.testing.assert_array_equal(before, want)
    for _name, step in SCRIPT:
        step(REF, m['ref'][0])
        step(PORT, m['port'][0])
    after, want = _render_both(m['ref'][1], m['port'][1], W_SCRIPT, 0, 48)
    np.testing.assert_array_equal(after, want)
    assert not np.array_equal(before, after)
    for f in (3, 20, 40):
        pull = m['port'][1].get_frame_f16(f, box2i(*W_SCRIPT))
        expect = (np.zeros_like(after[f]) if pull.current_window.empty()
                  else np.asarray(pull.data, np.float16))
        np.testing.assert_array_equal(after[f], expect)


# --- ranged invalidation into the plan cache ------------------------------------

def test_edit_ranged_invalidation_reaches_planner():
    """A model edit propagates a RANGED frames_updated through the
    port's SpaceVideoManager to a connected RenderPlanner, which keeps
    prepared plans for untouched segments and re-renders the dirty range
    correctly (the JAX editor's test of the same name, on the port)."""
    from canvas_tpu_torch import process
    from canvas_tpu_torch.editor import model

    slist = model.AssetList()
    for name, color in (('red', (100, 0, 0)), ('blue', (0, 0, 100))):
        source = process.SolidColorVideoSource(
            process.LerpFunc((0, 0, 0, 1),
                             (color[0], color[1], color[2], 1), 100))
        slist[name] = model.RuntimeSourceAsset(model.RuntimeSource(
            name, {'video': port_plugins.VideoStream(source)}))
    space = model.Space('test', port_plugins.VideoFormat(),
                        port_plugins.AudioFormat())
    clip_red = model.Clip(type='video', x=0, y=0.0, length=64, height=1.0,
                          source=model.AssetStreamRef('red', 'video'),
                          offset=0)
    clip_blue = model.Clip(type='video', x=40, y=1.0, length=20, height=1.0,
                           source=model.AssetStreamRef('blue', 'video'),
                           offset=0)
    space[0:0] = [clip_red, clip_blue]
    manager = port_graph.SpaceVideoManager(space, slist)

    window = box2i(0, 0, 31, 23)
    planner = port.RenderPlanner(manager, window, device='cpu')
    planner.pipeline_chunk = 64
    for (_s, _n, o) in planner.iter_batches(0, 64, batch=8):
        o.numpy()
    segs_before = sorted(k[0] for k in planner._plan_cache)
    assert (0, 40) in segs_before          # red-only segment

    clip_blue.update(offset=5)           # dirty range: [40, 59]
    segs_after = sorted(k[0] for k in planner._plan_cache)
    assert (0, 40) in segs_after
    assert all(s1 <= 40 or s0 >= 60 for (s0, s1) in segs_after)

    got = {s: o.numpy()[:n] for (s, n, o) in
           planner.iter_batches(0, 64, batch=8)}
    for i in (3, 45):
        want = manager.get_frame_f16(i, window)
        expect = (np.zeros((4, 24, 32), np.float16)
                  if want.current_window.empty()
                  else np.asarray(want.data, np.float16))
        np.testing.assert_array_equal(got[(i // 8) * 8][i % 8], expect,
                                      err_msg='frame %d' % i)
    planner.close()
