"""The port's own host side (canvas_tpu_torch's basetypes, framefuncs,
frames, sources, coded, ir, plan and timelines) against the JAX
package's, on the CPU.

- Plan parity: the headline and the mixed-content timeline, built by
  each package from its own classes (bench.build_timeline against
  timelines.build_timeline, benchmarks._mixed_timeline against
  timelines.mixed_timeline), planned by each package at 320x180 and
  1920x1080 over the segments of frames 0..16 and of a range across a
  segment cut: the same segments, the port's sliced signature equal to
  canvas_tpu.render._sliced_signature, every flat param
  ``np.array_equal`` with the same dtype, staged stacks (device tensors
  in the port) equal by content, and the same per-node window metadata.
- Pull parity: each copied source class gives get_frame_f32 and
  get_frame_f16 bit-equal to the JAX package's NumPy pull, each package
  pinned to its NumPy arm (``force_backend('numpy')``), as do the frame
  functions, the box algebra on seeded inputs and the public module's
  frame-time helpers (``canvas_tpu_torch.process``).
- A static scan: no module of the port, and not chip_smoke.py, imports
  the JAX package, the root scripts or JAX.
"""

import ast
import os

import numpy as np
import pytest
import torch

import bench
import benchmarks
from canvas_tpu import basetypes as ref_basetypes
from canvas_tpu import coded as ref_coded
from canvas_tpu import framefuncs as ref_framefuncs
from canvas_tpu import frames as ref_frames
from canvas_tpu import render as ref_render
from canvas_tpu import sources as ref_sources
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import basetypes as port_basetypes
from canvas_tpu_torch import coded as port_coded
from canvas_tpu_torch import framefuncs as port_framefuncs
from canvas_tpu_torch import frames as port_frames
from canvas_tpu_torch import ir
from canvas_tpu_torch import render as port_render
from canvas_tpu_torch import sources as port_sources
from canvas_tpu_torch import timelines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = dict(basetypes=ref_basetypes, coded=ref_coded,
           framefuncs=ref_framefuncs, frames=ref_frames,
           sources=ref_sources)
PORT = dict(basetypes=port_basetypes, coded=port_coded,
            framefuncs=port_framefuncs, frames=port_frames,
            sources=port_sources)


# --- plan parity --------------------------------------------------------

# (JAX builder, port builder, length, a range across a structure cut, the
# cut): the headline's scalers leave identity after frame 0, the mixed
# timeline ends at frame 16.
TIMELINES = {'headline': (bench.build_timeline, timelines.build_timeline, 64,
                          (0, 6), 1),
             'mixed': (benchmarks._mixed_timeline, timelines.mixed_timeline,
                       16, (12, 20), 16)}
WINDOWS = {'320x180': (0, 0, 319, 179), '1920x1080': (0, 0, 1919, 1079)}


def _walk(node, out=None):
    out = [] if out is None else out
    out.append(node)
    for c in node.children:
        _walk(c, out)
    return out


@pytest.fixture(scope='module')
def built():
    return {name: (ref(n), port(n))
            for name, (ref, port, n, _r, _c) in TIMELINES.items()}


@pytest.mark.parametrize('window', sorted(WINDOWS))
@pytest.mark.parametrize('name', sorted(TIMELINES))
def test_plan_matches_jax(built, name, window):
    ref_ws, port_ws = built[name]
    cut_range, cut = TIMELINES[name][3:]
    win = WINDOWS[window]
    rp = ref_render.RenderPlanner(ref_ws, ref_basetypes.box2i(*win))
    pp = port_render.RenderPlanner(port_ws, port_basetypes.box2i(*win),
                                   device='cpu')
    rp.stage_cache_mb = pp.stage_cache_mb = 0
    pp.pipeline_chunk = rp.pipeline_chunk = 4
    segs = pp.segments(0, 17) + pp.segments(*cut_range, min_span=4)
    assert segs == rp.segments(0, 17) + rp.segments(*cut_range, min_span=4)
    assert cut in [s0 for s0, _s1 in pp.segments(*cut_range, min_span=4)]
    for seg in segs:
        N = seg[1] - seg[0]
        rp._stage_cache, rp._frame_hints = {}, {}
        ref = ref_render.PlanContext(rp, np.arange(*seg),
                                     rp.window).plan(ref_ws)
        got = pp._plan(seg)
        for B in (N, 2):
            assert (port_render.sliced_signature(got, N, B)
                    == ref_render._sliced_signature(ref, N, B))
        for p, q in zip(port_render.flat_params(got), ref.flat_params([])):
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


def test_explain_marks_staged_stacks(built):
    _ref, port_ws = built['mixed']
    planner = port_render.RenderPlanner(
        port_ws, port_basetypes.box2i(0, 0, 319, 179), device='cpu')
    text = planner.explain(0, 3)
    assert 'segment [0, 1)' in text and 'segment [1, 3)' in text
    assert 'py(8, 480, 720)@dev' in text and 'stage cache:' in text


# --- pull parity --------------------------------------------------------

def _dv_source(lib):
    class Rolled(lib['coded'].CodedImageSource):
        def __init__(self):
            rng = np.random.RandomState(17)
            self.planes = (
                rng.randint(16, 236, (480, 720)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8))

        def get_frame(self, frame_index, quality=0):
            return lib['coded'].CodedImage(
                [np.roll(p, frame_index, axis=0) for p in self.planes])

    return lib['coded'].DVReconstructionFilter(Rolled())


def _graph(lib, kind, arg=None):
    """One source of each copied class, built from *lib*'s modules."""
    src, ff = lib['sources'], lib['framefuncs']
    box = lib['basetypes'].box2i
    card = src.SolidColorVideoSource(
        ff.LerpFunc((0.9, 0.2, 0.1, 0.7), (0.1, 0.8, 0.6, 1.3), 8),
        ff.LerpFunc((-20, 10, 90, 70), (40, -5, 150, 130), 8))
    if kind == 'empty':
        return src.EmptyVideoSource()
    if kind == 'solid':
        return card
    if kind == 'gain_offset':
        return src.VideoGainOffsetFilter(card, gain=ff.LinearFrameFunc(
            0.05, 0.6), offset=0.125)
    if kind == 'mix':
        other = src.SolidColorVideoSource((0.2, 0.3, 0.9, 0.5),
                                          box(30, 20, 110, 90))
        return src.VideoMixFilter(card, other, ff.LerpFunc(
            (-0.5,), (1.5,), 7))
    if kind == 'scaler':
        return src.VideoScaler(
            card, target_point=ff.LerpFunc((10, 5), (80, 60), 8),
            source_point=(3.0, 2.0),
            scale_factors=ff.LerpFunc((0.6, 1.0), (1.7, 0.45), 8),
            source_rect=box(0, 0, 100, 80))
    if kind == 'workspace':
        ws = src.VideoWorkspace()
        ws.add(source=src.SolidColorVideoSource((0.1, 0.1, 0.2, 1.0)), x=0,
               length=8, z=0)
        ws.add(source=card, x=1, length=6, offset=2, z=2)
        ws.add(source=_graph(lib, 'scaler'), x=0, length=8, z=1)
        return ws
    if kind == 'sequence':
        return src.VideoSequence([(card, 3, 2), (_graph(lib, 'mix'), 0, 3),
                                  (None, 0, 1), (card, 0, 4)])
    if kind == 'pass_through':
        return src.VideoPassThroughFilter(card, offset=2, start_frame=1,
                                          end_frame=6)
    if kind == 'transfer':
        return src.VideoColorTransferFilter(_graph(lib, 'workspace'), arg)
    if kind == 'dv':
        return _dv_source(lib)
    if kind == 'dv_scaled':
        return src.VideoScaler(_dv_source(lib), target_point=(60.0, 40.0),
                               source_point=(0.0, -1.0),
                               scale_factors=(0.25, 0.25),
                               source_rect=box(0, -1, 719, 478))
    if kind == 'frame':
        rng = np.random.RandomState(23)
        data = rng.uniform(0, 1, (4, 40, 60)).astype(np.float32)
        return lib['frames'].RgbaFrameF32(box(-10, 5, 49, 44), data,
                                          box(-4, 8, 30, 40))
    raise ValueError(kind)


PULL_CASES = (['empty', 'solid', 'gain_offset', 'mix', 'scaler',
               'workspace', 'sequence', 'pass_through', 'dv', 'dv_scaled',
               'frame']
              + ['transfer-' + t for t in
                 port_sources.VideoColorTransferFilter.TRANSFORMS])


@pytest.mark.parametrize('kind', PULL_CASES)
def test_pull_matches_jax(kind, numpy_backend):
    kind, _, arg = kind.partition('-')
    ref, got = _graph(REF, kind, arg), _graph(PORT, kind, arg)
    for win in ((-12, -6, 150, 100), (20, 10, 83, 47)):
        rwin, pwin = ref_basetypes.box2i(*win), port_basetypes.box2i(*win)
        for f in (0, 1, 4, 7):
            for getter in ('get_frame_f32', 'get_frame_f16'):
                want = getattr(ref, getter)(f, rwin)
                with port_backend.force_backend('numpy'):
                    have = getattr(got, getter)(f, pwin)
                assert tuple(have.current_window.min) == tuple(
                    want.current_window.min)
                assert tuple(have.current_window.max) == tuple(
                    want.current_window.max)
                w = np.asarray(want.data)
                assert isinstance(have.data, np.ndarray)
                assert have.data.dtype == w.dtype and have.data.shape == w.shape
                np.testing.assert_array_equal(have.data.view(np.uint8),
                                              w.view(np.uint8))


@pytest.mark.parametrize('name', sorted(TIMELINES))
def test_timeline_pull_matches_jax(built, name, numpy_backend):
    ref_ws, port_ws = built[name]
    for f in (0, 5):
        want = ref_ws.get_frame_f16(f, ref_basetypes.box2i(0, 0, 319, 179))
        with port_backend.force_backend('numpy'):
            have = port_ws.get_frame_f16(f, port_basetypes.box2i(0, 0, 319,
                                                                 179))
        np.testing.assert_array_equal(have.data.view(np.uint16),
                                      np.asarray(want.data).view(np.uint16))


def _animation(ff):
    fn = ff.AnimationFunc()
    fn.add(ff.POINT_LINEAR, 2.0, (0.0, 1.0, -3.0, 0.5))
    fn.add(ff.POINT_HOLD, 7.5, (4.0, -2.0, 1.0, 1.5))
    fn.add(ff.POINT_LINEAR, 5.0, (1.0, 0.0, 2.5, -1.0))
    fn.add(ff.POINT_LINEAR, 11.0, (-1.0, 3.0, 0.0, 0.25))
    return fn


def _framefuncs(ff, basetypes):
    return [ff.LerpFunc((0.1, -2.5, 3.0, 0.7), (9.5, 4.25, -1.0, 1.2), 13),
            ff.LinearFrameFunc(0.37, -1.5), _animation(ff),
            ff.FrameFuncPassThroughFilter(_animation(ff), 2.5),
            ff.as_framefunc((1.5, 2.5)), ff.as_framefunc(7.25),
            ff.as_framefunc(basetypes.box2i(1, 2, 30, 40)),
            ff.as_framefunc(basetypes.v2f(0.5, -0.25)), ff.as_framefunc(None)]


def test_framefuncs_match_jax():
    frames = np.random.default_rng(29).uniform(-4, 16, 64)
    frames[:6] = (0.0, 2.0, 5.0, 7.5, 11.0, 3.5)
    pairs = zip(_framefuncs(port_framefuncs, port_basetypes),
                _framefuncs(ref_framefuncs, ref_basetypes))
    for got, want in pairs:
        np.testing.assert_array_equal(got.get_values_array(frames),
                                      want.get_values_array(frames))
        assert got.get_values(3) == want.get_values(3)
        for name in ('get_box2i_array', 'get_v2f_array', 'get_f32_array'):
            np.testing.assert_array_equal(
                getattr(port_framefuncs, name)(got, frames),
                getattr(ref_framefuncs, name)(want, frames))
        for f in frames[:10]:
            for name in ('get_i32', 'get_f32', 'get_v2f', 'get_box2i',
                         'get_rgba_f32'):
                g = getattr(port_framefuncs, name)(got, f)
                w = getattr(ref_framefuncs, name)(want, f)
                assert np.array_equal(np.asarray(g, np.float64),
                                      np.asarray(w, np.float64)), (name, f)


def test_box_algebra_matches_jax():
    rng = np.random.default_rng(31)
    boxes = rng.integers(-50, 50, (200, 4))
    boxes[::7, 2] = boxes[::7, 0] - 1          # some empty boxes
    pb, rb = port_basetypes, ref_basetypes
    for a, b in zip(boxes[::2], boxes[1::2]):
        pa, pbb = pb.box2i(*map(int, a)), pb.box2i(*map(int, b))
        ra, rbb = rb.box2i(*map(int, a)), rb.box2i(*map(int, b))
        for name in ('box2i_intersect', 'box2i_union'):
            g, w = getattr(pb, name)(pa, pbb), getattr(rb, name)(ra, rbb)
            assert (tuple(g.min), tuple(g.max)) == (tuple(w.min),
                                                    tuple(w.max)), name
        g, w = pb.box2i_normalize(pa), rb.box2i_normalize(ra)
        assert (tuple(g.min), tuple(g.max)) == (tuple(w.min), tuple(w.max))
        assert (pa.empty(), pa.width, pa.height) == (ra.empty(), ra.width,
                                                      ra.height)
        assert pa.contains_point(3, -4) == ra.contains_point(3, -4)


def test_process_matches_jax():
    from fractions import Fraction

    from canvas_tpu import process as ref_process
    from canvas_tpu_torch import process
    for name in ('v2i', 'box2i', 'RgbaFrameF16', 'LerpFunc', 'VideoWorkspace',
                 'VideoScaler', 'DVReconstructionFilter', 'CodedImage',
                 'PlanarReconstructionFilter', 'DVSubsampleFilter',
                 'MPEG2SubsampleFilter', 'Pulldown23RemovalFilter',
                 'VideoWorkspaceItem', 'POINT_LINEAR'):
        assert hasattr(process, name) and hasattr(ref_process, name), name
    assert process.NS_PER_SEC == ref_process.NS_PER_SEC
    for rate in (Fraction(30000, 1001), (25, 1), Fraction(24, 1)):
        for frame in (-7, 0, 1, 29, 1000):
            t = process.get_frame_time(rate, frame)
            assert t == ref_process.get_frame_time(rate, frame)
            for time in (t, t - 1, -t, 0):
                assert (process.get_time_frame(rate, time)
                        == ref_process.get_time_frame(rate, time))


# --- the port imports nothing of the JAX package ------------------------

REFUSED = ('canvas_tpu', 'bench', 'benchmarks', 'scripts', 'jax', 'jaxlib')


def _port_files():
    root = os.path.join(REPO, 'canvas_tpu_torch')
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)
    yield os.path.join(REPO, 'chip_smoke.py')


def test_port_imports_nothing_of_the_jax_package():
    files = list(_port_files())
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ''] if node.level == 0 else []
            else:
                continue
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split('.')[0] in REFUSED]
    assert not bad, bad
