"""The port's coded-video path against the JAX package, on the CPU: the
planar, subsample and 2:3-pulldown filters of ``canvas_tpu_torch.coded``,
their NumPy math in ``canvas_tpu_torch.ops.chroma``, and the two device
ops they plan, ``planar_recon_rows`` and ``field_interleave``. Inputs are
seeded NumPy planes; each package builds its own graph from them.

Tolerances:

- NumPy against NumPy (``reconstruct_planar``, ``subsample_dv``,
  ``subsample_mpeg2``, the cadence maps, the plans' params): equal.
- ``field_interleave`` on the same children: bit-equal (a select).
- ``planar_recon_rows`` on the same params: the port's f32 contractions
  sum in another order than XLA's on this CPU; a last-ulp difference
  before the truncating f16 grid moves a value by one f16 step into the
  transfer table. At least 99.99% of values within 1 f16 ulp, all within
  atol 4e-3 (the ``dv_recon_rows`` result of test_torch_mixed.py).
- Rendered frames (f16) against the NumPy pull path and against
  ``canvas_tpu.render`` on CPU JAX: atol 1e-2 with at least 99% of
  values bit-equal (tests/test_chroma.py's own limits).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from canvas_tpu import coded as ref_coded
from canvas_tpu import framefuncs as ref_framefuncs
from canvas_tpu import render as ref_render
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.ops import chroma as ref_chroma
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import coded as port_coded
from canvas_tpu_torch import framefuncs as port_framefuncs
from canvas_tpu_torch import ir
from canvas_tpu_torch import process
from canvas_tpu_torch import render as port
from canvas_tpu_torch import sources as port_sources
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ops import chroma as port_chroma

CPU = torch.device('cpu')

REF = dict(box2i=ref_box2i, coded=ref_coded, framefuncs=ref_framefuncs,
           sources=ref_sources)
PORT = dict(box2i=box2i, coded=port_coded, framefuncs=port_framefuncs,
            sources=port_sources)


def _planes(seed, yshape, cshape):
    rng = np.random.RandomState(seed)
    return (rng.randint(16, 236, yshape).astype(np.uint8),
            rng.randint(16, 241, cshape).astype(np.uint8),
            rng.randint(16, 241, cshape).astype(np.uint8))


def _coded_source(lib, get_planes, counter=None):
    """A CodedImageSource of *lib* whose frame f holds get_planes(f) (None
    passes through as a failed pull); *counter* collects the pulls."""

    class Source(lib['coded'].CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            if counter is not None:
                counter.append(frame_index)
            planes = get_planes(frame_index)
            return None if planes is None else lib['coded'].CodedImage(
                list(planes))

    return Source()


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


def _frames_close(got, want):
    """Rendered f16 frames: atol 1e-2, at least 99% bit-equal."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-2)
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.99


def _pull(source, window, start, stop):
    """The NumPy pull path's f16 frames (zeros where the frame is empty),
    pinned to the eager pull's NumPy arm."""
    out = []
    for i in range(start, stop):
        with port_backend.force_backend('numpy'):
            frame = source.get_frame_f16(i, window)
        out.append(np.asarray(frame.data, np.float16)
                   if not frame.current_window.empty()
                   else np.zeros((4, window.height, window.width),
                                 np.float16))
    return np.stack(out)


# --- the NumPy math -------------------------------------------------------

GEOMETRIES = {'420': ((48, 64), (24, 32)), '422': ((48, 64), (48, 32)),
              '411': ((48, 64), (48, 16)), '444': ((48, 64), (48, 64))}


@pytest.mark.parametrize('matrix', ['rec709', 'rec601'])
@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_reconstruct_planar_matches_jax(geometry, matrix):
    yshape, cshape = GEOMETRIES[geometry]
    planes = _planes(11, yshape, cshape)
    for win in ((0, 0, 63, 47), (-5, 3, 80, 40), (100, 100, 120, 120)):
        got, gw = port_chroma.reconstruct_planar(planes, box2i(*win),
                                                 matrix=matrix)
        want, ww = ref_chroma.reconstruct_planar(
            planes, ref_box2i(*win), use_jax=False, matrix=matrix)
        assert (tuple(gw.min), tuple(gw.max)) == (tuple(ww.min),
                                                  tuple(ww.max))
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got.view(np.uint16),
                                      np.asarray(want).view(np.uint16))
    for name, args in (('_up_matrix_generic', (yshape[1], cshape[1])),
                       ('_up_matrix_generic', (yshape[0], cshape[0], 0.5)),
                       ('_vertical_siting', (yshape[0], cshape[0])),
                       ('ycbcr_matrix', (matrix,))):
        np.testing.assert_array_equal(getattr(port_chroma, name)(*args),
                                      getattr(ref_chroma, name)(*args))
    with pytest.raises(ValueError, match='rec709'):
        port_chroma.ycbcr_matrix('bt2020')


@pytest.mark.parametrize('window', [(0, -1, 719, 478), (3, 2, 700, 470),
                                    (900, 900, 910, 910)])
def test_subsample_dv_matches_jax(window, numpy_backend):
    rng = np.random.RandomState(7)
    data = (rng.rand(4, 480, 720) * 0.9).astype(np.float16)
    full = (0, -1, 719, 478)
    got = port_chroma.subsample_dv(data, box2i(*full), box2i(*window))
    want = ref_chroma.subsample_dv(data, ref_box2i(*full),
                                   ref_box2i(*window))
    for g, w, shape in zip(got, want, ((480, 720), (480, 180), (480, 180))):
        assert g.dtype == np.uint8 and g.shape == shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_chroma._dv_down_matrix(),
                                  ref_chroma._dv_down_matrix())


def test_subsample_mpeg2_matches_jax(numpy_backend):
    rng = np.random.RandomState(9)
    data = (rng.rand(4, 48, 64) * 1.1).astype(np.float32)
    got = port_chroma.subsample_mpeg2(data, box2i(0, 0, 63, 47))
    want = ref_chroma.subsample_mpeg2(data, ref_box2i(0, 0, 63, 47))
    for g, w, shape in zip(got, want, ((48, 64), (24, 32), (24, 32))):
        assert g.dtype == np.uint8 and g.shape == shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('kind', ['DVSubsampleFilter',
                                  'MPEG2SubsampleFilter'])
def test_subsample_filters_match_jax(kind, numpy_backend):
    def graph(lib):
        card = lib['sources'].SolidColorVideoSource(
            lib['framefuncs'].LerpFunc((0.9, 0.2, 0.1, 1.0),
                                       (0.1, 0.8, 0.6, 1.0), 4),
            lib['box2i'](40, 30, 600, 400))
        return getattr(lib['coded'], kind)(card)

    got, want = graph(PORT), graph(REF)
    for f in (0, 3):
        with port_backend.force_backend('numpy'):
            g = got.get_frame(f)
        w = want.get_frame(f)
        assert isinstance(g, port_coded.CodedImage) and len(g) == len(w) == 3
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(g[i]), np.asarray(w[i]))
    assert getattr(port_coded, kind)(None).get_frame(0) is None


# --- the pulldown cadence -------------------------------------------------

def _sequence(lib):
    src = lib['sources']
    seq = src.VideoSequence()
    seq.append((src.SolidColorVideoSource((1.0, 0.0, 0.0, 1.0)), 2, 12))
    seq.append((src.SolidColorVideoSource((0.0, 1.0, 0.0, 1.0)), 0, 9))
    seq.append((src.SolidColorVideoSource((0.0, 0.0, 1.0, 0.5)), 0, 30))
    return seq


@pytest.mark.parametrize('offset', range(5))
def test_pulldown_cadence_matches_jax(offset):
    got = port_coded.Pulldown23RemovalFilter(_sequence(PORT), offset)
    want = ref_coded.Pulldown23RemovalFilter(_sequence(REF), offset)
    assert [got._map(f) for f in range(-8, 48)] == \
        [want._map(f) for f in range(-8, 48)]
    assert [got.get_new_length(n) for n in range(40)] == \
        [want.get_new_length(n) for n in range(40)]
    for rng in ((0, 40), (4, 14), (9, 11), (7, 7), (12, 3)):
        assert got.plan_cuts(*rng) == want.plan_cuts(*rng), rng
    assert got.plan_cuts(0, 40)            # the sequence's cuts map through
    # the deliberate departures from the C: offset 4's first film frame
    # of a group, offset 3's length
    if offset == 4:
        assert got._map(4) == (5, None)
    if offset == 3:
        assert got.get_new_length(5) == 3
    with pytest.raises(ValueError, match='offset'):
        port_coded.Pulldown23RemovalFilter(None, 5)
    empty = port_coded.Pulldown23RemovalFilter(None, offset)
    assert empty.plan_cuts(0, 8) == []
    assert empty.get_frame_f16(0, box2i(0, 0, 7, 7)).current_window.empty()


@pytest.mark.parametrize('offset', range(5))
def test_pulldown_pull_matches_jax(offset, numpy_backend):
    """The NumPy pull path, solid and mixed cadence frames, through a
    window whose rows start at a negative odd y."""
    got = port_coded.Pulldown23RemovalFilter(_sequence(PORT), offset)
    want = ref_coded.Pulldown23RemovalFilter(_sequence(REF), offset)
    for f in range(4, 14):
        g = got.get_frame_f16(f, box2i(-3, -5, 12, 10))
        w = want.get_frame_f16(f, ref_box2i(-3, -5, 12, 10))
        assert (tuple(g.current_window.min), tuple(g.current_window.max)) \
            == (tuple(w.current_window.min), tuple(w.current_window.max))
        np.testing.assert_array_equal(
            np.asarray(g.data).view(np.uint16),
            np.asarray(w.data, np.float16).view(np.uint16))


# --- plans equal to the JAX package's -------------------------------------

def _rolled_dv(lib, seed=7):
    planes = _planes(seed, (480, 720), (480, 180))
    return _coded_source(lib, lambda f: [np.roll(p, f, axis=0)
                                         for p in planes])


def _pulldown_scaled(lib, counter=None):
    """A pulldown clip under an animated scaler, over a background, in a
    workspace."""
    src, ff = lib['sources'], lib['framefuncs']
    planes = _planes(7, (480, 720), (480, 180))
    dv = _coded_source(lib, lambda f: [np.roll(p, f, axis=0)
                                       for p in planes], counter)
    clip = src.VideoScaler(
        lib['coded'].Pulldown23RemovalFilter(
            lib['coded'].DVReconstructionFilter(dv), 1),
        target_point=ff.LerpFunc((20, 10), (60, 40), 16),
        source_point=(0.0, -1.0), scale_factors=(0.25, 0.25),
        source_rect=lib['box2i'](0, -1, 719, 478))
    ws = src.VideoWorkspace()
    ws.add(source=src.SolidColorVideoSource((0.2, 0.3, 0.4, 1.0)), x=0,
           length=16, z=0)
    ws.add(source=clip, x=0, length=16, z=1)
    return ws


def _config3(lib):
    planes = timelines.FixedDV().planes
    return lib['coded'].Pulldown23RemovalFilter(
        lib['coded'].DVReconstructionFilter(
            _coded_source(lib, lambda f: planes)), 0)


def _config8(lib, length=8):
    rolled = timelines.RolledPlanar(length)
    return lib['coded'].PlanarReconstructionFilter(
        _coded_source(lib, lambda f: (
            [np.asarray(p) for p in rolled.get_frame(f).planes]
            if 0 <= f < length else None)), width=1920, height=1080)


# name: (the port's source, the JAX package's, window, segments)
PLAN_CASES = {
    'pulldown_clip': (timelines.pulldown_clip, lambda: _config3(REF),
                      (0, -1, 719, 478), [(0, 8), (5, 7)]),
    'planar_clip': (lambda: timelines.planar_clip(8), lambda: _config8(REF),
                    (0, 0, 1919, 1079), [(0, 3)]),
    'planar_clip_cropped': (lambda: timelines.planar_clip(8),
                            lambda: _config8(REF), (100, -20, 419, 159),
                            [(2, 5)]),
    'pulldown_scaled': (lambda: _pulldown_scaled(PORT),
                        lambda: _pulldown_scaled(REF), (0, 0, 319, 179),
                        [(0, 1), (1, 9)]),
}


@pytest.mark.parametrize('name', sorted(PLAN_CASES))
def test_plan_matches_jax(name):
    make_port, make_ref, win, segs = PLAN_CASES[name]
    port_src, ref_src = make_port(), make_ref()
    rp = ref_render.RenderPlanner(ref_src, ref_box2i(*win))
    pp = port.RenderPlanner(port_src, box2i(*win), device='cpu')
    rp.stage_cache_mb = pp.stage_cache_mb = 0
    assert pp.segments(0, 12) == rp.segments(0, 12)
    ops = set()
    for seg in segs:
        N = seg[1] - seg[0]
        rp._stage_cache, rp._frame_hints = {}, {}
        ref = ref_render.PlanContext(rp, np.arange(*seg),
                                     rp.window).plan(ref_src)
        got = pp._plan(seg)
        for B in (N, 1):
            assert (port.sliced_signature(got, N, B)
                    == ref_render._sliced_signature(ref, N, B))
        for p, q in zip(port.flat_params(got), ref.flat_params([])):
            assert sorted(p) == sorted(q)
            for k in q:
                v = p[k].numpy() if isinstance(p[k], torch.Tensor) else p[k]
                w = np.asarray(q[k])
                assert v.dtype == w.dtype and np.array_equal(v, w), (seg, k)
        for a, b in zip(_walk(got), _walk(ref)):
            assert a.op == b.op
            ops.add(a.op)
            np.testing.assert_array_equal(
                ir.windows_to_array(a.windows),
                ref_render.windows_to_array(b.windows))
    want_op = ('planar_recon_rows' if name.startswith('planar')
               else 'field_interleave')
    assert want_op in ops, ops


# --- the two device ops against canvas_tpu.render._eval -------------------

def _eval_both(pick):
    sig = pick.signature()
    params = pick.flat_params([])
    want = np.asarray(ref_render._eval(sig, iter(params), jnp, jax))
    tparams = port.params_to_torch(
        [{k: np.asarray(v) for k, v in p.items()} for p in params], CPU)
    got = port._eval(sig, iter(tparams), CPU).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    return got, want


def _ref_node(source, window, start, stop, op):
    window = ref_box2i(*window)
    planner = ref_render.RenderPlanner(source, window)
    planner.stage_cache_mb = 0
    node = ref_render.PlanContext(planner, np.arange(start, stop),
                                  window).plan(source)
    return [n for n in _walk(node) if n.op == op][0]


# (source, window): solids whose windows start at negative odd and even
# rows, the DV clip at config3's window (row -1 on top), and the mixed
# frames of a pulldown nested under a scaler's smaller pulls.
INTERLEAVE_CASES = {
    'negative_rows': (lambda: ref_coded.Pulldown23RemovalFilter(
        ref_sources.VideoSequence([
            (ref_sources.SolidColorVideoSource(
                ref_framefuncs.LerpFunc((1, 0, 0, 1), (0, 1, 0, 0.5), 40),
                ref_framefuncs.LerpFunc((-9, -7, 20, 14), (-2, -12, 30, 9),
                                        40)), 0, 40)]), 0),
        (-6, -9, 25, 12), (0, 12)),
    'dv_clip': (lambda: _config3(REF), (0, -1, 719, 478), (0, 4)),
    'under_a_scaler': (lambda: _pulldown_scaled(REF), (0, 0, 319, 179),
                       (1, 9)),
}


@pytest.mark.parametrize('case', sorted(INTERLEAVE_CASES))
def test_field_interleave_matches_jax(case):
    make, window, (start, stop) = INTERLEAVE_CASES[case]
    pick = _ref_node(make(), window, start, stop, 'field_interleave')
    starts, ends = pick.params['start_y'], pick.params['end_y']
    assert (ends >= starts).any() and (ends < starts).any()   # both kinds
    if case == 'negative_rows':
        assert pick.static[0] < 0 and (starts < 0).any()
    got, want = _eval_both(pick)
    if case == 'negative_rows':
        np.testing.assert_array_equal(got, want)      # solids: exact
    else:
        # the children are DV reconstructions (matmuls in another order):
        # the select itself adds nothing to their difference
        a, want_a = _eval_both(pick.children[0])
        b, want_b = _eval_both(pick.children[1])
        H, W = got.shape[2:]
        rows = (np.arange(H) + pick.static[0])[None, None, :, None]
        cols = (np.arange(W) + pick.static[1])[None, None, None, :]
        p = {k: np.asarray(v)[:, None, None, None]
             for k, v in pick.params.items()}
        mask = ((rows >= p['start_y']) & (rows <= p['end_y'])
                & (rows % 2 == 0) & (cols >= p['x0']) & (cols <= p['x1']))
        assert mask.any() and not mask.all()
        np.testing.assert_array_equal(got, np.where(mask, b, a))
        np.testing.assert_array_equal(want, np.where(mask, want_b, want_a))


@pytest.mark.parametrize('matrix', ['rec709', 'rec601'])
@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_planar_recon_rows_matches_jax(geometry, matrix):
    yshape, cshape = (tuple(2 * v for v in s) for s in GEOMETRIES[geometry])
    src = ref_coded.PlanarReconstructionFilter(
        _coded_source(REF, lambda f: _planes(f, yshape, cshape)),
        matrix=matrix)
    pick = _ref_node(src, (0, 0, yshape[1] - 1, yshape[0] - 1), 0, 5,
                     'planar_recon_rows')
    got, want = _eval_both(pick)
    assert got.shape == (5, 4) + yshape
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
    assert np.mean(_ulps_f16(got, want) <= 1) >= 0.9999
    assert np.mean(got == want) >= 0.99


# --- rendered frames: the port's batched path, its pull path, the JAX
# package's batched path -------------------------------------------------

RENDER_CASES = {
    'pulldown_clip': (lambda lib: _config3(lib), (0, -1, 719, 478), (0, 6)),
    'pulldown_window_inside': (lambda lib: _config3(lib),
                               (10, 5, 200, 90), (2, 4)),
    'planar_420': (lambda lib: lib['coded'].PlanarReconstructionFilter(
        _coded_source(lib, lambda f: _planes(f, (96, 128), (48, 64)))),
        (0, 0, 159, 127), (0, 4)),
    'planar_422_rec601': (
        lambda lib: lib['coded'].PlanarReconstructionFilter(
            _coded_source(lib, lambda f: _planes(f, (48, 64), (48, 32))),
            matrix='rec601'), (-8, -4, 55, 43), (1, 3)),
    'pulldown_scaled': (_pulldown_scaled, (0, 0, 319, 179), (0, 9)),
}


@pytest.mark.parametrize('name', sorted(RENDER_CASES))
def test_render_matches_pull_and_jax(name):
    make, win, (start, stop) = RENDER_CASES[name]
    src = make(PORT)
    planner = port.RenderPlanner(src, box2i(*win), device='cpu')
    got = planner.render(start, stop)
    assert np.isfinite(got).all() and got[:, 3].max() > 0
    _frames_close(got, _pull(src, box2i(*win), start, stop))
    _frames_close(got, np.asarray(ref_render.render_frames(
        make(REF), ref_box2i(*win), start, stop)))
    streamed = np.concatenate([
        out.numpy() for _s, _n, out in planner.iter_batches(start, stop,
                                                            batch=2)])
    np.testing.assert_array_equal(streamed, got)


def test_timelines_render_like_their_pull_paths():
    """``pulldown_clip`` (solid and mixed cadence frames) and a cropped
    window of ``planar_clip`` through iter_batches."""
    src = timelines.pulldown_clip()
    planner = port.RenderPlanner(src, timelines.PULLDOWN_WINDOW,
                                 device='cpu')
    got = np.concatenate([o.numpy() for _s, _n, o in
                          planner.iter_batches(0, 4, batch=4)])
    _frames_close(got, _pull(src, timelines.PULLDOWN_WINDOW, 0, 4))
    src = timelines.planar_clip(4)
    window = box2i(1700, 1000, 1930, 1090)      # the picture's corner
    planner = port.RenderPlanner(src, window, device='cpu')
    got = planner.render(1, 3)
    assert not got[:, :, :, 220:].any() and not got[:, :, 80:].any()
    _frames_close(got, _pull(src, window, 1, 3))
    assert src.source.get_frame(4) is None      # past the end


# --- fall-backs and staging ----------------------------------------------

def _late_start(f):
    return None if f < 2 else _planes(f, (48, 64), (24, 32))


def _shape_shift(f):
    return (_planes(f, (96, 128), (48, 64)) if f < 2
            else _planes(f, (48, 64), (24, 32)))


FALLBACKS = {
    # frame 0 gives no geometry: the filter is host-staged
    'unknown_geometry': (_late_start, {}, (0, 0, 63, 47)),
    # the plane size changes inside the segment
    'midstream_shape_change': (_shape_shift, dict(width=128, height=96),
                               (0, 0, 127, 95)),
    # the declared size is not the decoded one: one decode, then bail
    'declared_size_wrong': (lambda f: _planes(f, (48, 64), (24, 32)),
                            dict(width=128, height=96), (0, 0, 127, 95)),
}


@pytest.mark.parametrize('name', sorted(FALLBACKS))
def test_planar_emit_falls_back_to_host_staging(name):
    get_planes, kw, win = FALLBACKS[name]
    pulls = []
    filt = port_coded.PlanarReconstructionFilter(
        _coded_source(PORT, get_planes, pulls), **kw)
    window = box2i(*win)
    want = _pull(filt, window, 0, 4)
    planner = port.RenderPlanner(filt, window, device='cpu')
    pulls.clear()
    assert planner._plan((0, 4)).op == 'stage_rows'
    if name == 'declared_size_wrong':
        # the emitter decoded ONE frame before it gave up; the host
        # staging then pulled each of the four
        assert sorted(pulls) == [0, 0, 1, 2, 3]
    np.testing.assert_array_equal(planner.render(0, 4), want)


def test_planar_probe_failure_recovers():
    calls = []

    def flaky(f):
        calls.append(f)
        return None if len(calls) <= 2 else _planes(f, (48, 64), (24, 32))

    filt = port_coded.PlanarReconstructionFilter(_coded_source(PORT, flaky))
    window = box2i(0, 0, 63, 47)
    planner = port.RenderPlanner(filt, window, device='cpu')
    first = planner.render(0, 2)           # probe fails; a later pull heals
    assert filt._size == (64, 48) and not first[0].any()
    assert planner._plan((2, 4)).children[0].op == 'planar_recon_rows'
    second = planner.render(2, 4)
    steady = port_coded.PlanarReconstructionFilter(_coded_source(
        PORT, lambda f: _planes(f, (48, 64), (24, 32))))
    want = port.RenderPlanner(steady, window, device='cpu').render(0, 4)
    np.testing.assert_array_equal(second, want[2:])
    # three failed probes and no healing pull: the filter stops probing
    dead = port_coded.PlanarReconstructionFilter(
        _coded_source(PORT, lambda f: None))
    assert [dead._geometry() for _ in range(5)] == [None] * 5
    assert dead._probe_fails == 3
    planner.close()


def test_planar_filter_arguments():
    src = _coded_source(PORT, lambda f: None)
    with pytest.raises(TypeError, match='CodedImageSource'):
        port_coded.PlanarReconstructionFilter(object())
    with pytest.raises(ValueError, match='matrix'):
        port_coded.PlanarReconstructionFilter(src, matrix='bt2020')
    with pytest.raises(ValueError, match='together'):
        port_coded.PlanarReconstructionFilter(src, width=64)
    with pytest.raises(ValueError, match='positive'):
        port_coded.PlanarReconstructionFilter(src, width=0, height=8)
    for name in ('PlanarReconstructionFilter', 'DVSubsampleFilter',
                 'MPEG2SubsampleFilter', 'Pulldown23RemovalFilter'):
        assert getattr(process, name) is getattr(port_coded, name)


@pytest.mark.parametrize('through', ['direct', 'pass_through', 'scaled'])
def test_pulldown_children_share_one_stack(through):
    """Pulldown's two children stage ONE plane stack: every coded frame
    is pulled once in a plan, also through a retiming pass-through and
    under a scaler."""
    pulls = []
    if through == 'scaled':
        src = _pulldown_scaled(PORT, pulls)
        window = box2i(0, 0, 319, 179)
    else:
        planes = _planes(3, (480, 720), (480, 180))
        dv = port_coded.DVReconstructionFilter(_coded_source(
            PORT, lambda f: [np.roll(p, f, axis=0) for p in planes], pulls))
        if through == 'pass_through':
            dv = port_sources.VideoPassThroughFilter(dv, offset=3)
        src = port_coded.Pulldown23RemovalFilter(dv, 0)
        window = box2i(0, -1, 719, 478)
    want = _pull(src, window, 1, 9)
    pulls.clear()
    planner = port.RenderPlanner(src, window, device='cpu')
    planner.stage_cache_mb = 0
    node = planner._plan((1, 9))
    assert len(pulls) == len(set(pulls)) >= 8, pulls
    stacks = {id(n.params['py']) for n in _walk(node)
              if n.op == 'dv_recon_rows'}
    assert len(stacks) == 1
    _frames_close(planner.render(1, 9), want)
