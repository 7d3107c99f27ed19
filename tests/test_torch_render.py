"""The PyTorch port's render path (canvas_tpu_torch.render) against the
JAX package's, on the CPU.

The headline timeline is built twice from the same code, by the JAX
package (bench.build_timeline) and by the port
(canvas_tpu_torch.timelines.build_timeline), and each package plans its
own. The two plans must have the same signature; the JAX plan goes
through canvas_tpu.render's program (its _eval plus the f16 root cast,
on CPU JAX) and the port's through the port's _eval (plain PyTorch
versions of the kernels). Tolerance: f16 outputs within atol=1e-3 (one
f16 ulp at 1.0) with at least 99.9% of values bit-equal; on this CPU
every case measured 100% bit-equal. Against the NumPy pull path the
tolerance is test_render.py's assert_matches_pull, atol=2e-3.

The export conversions (``iter_batches(post=...)``) against the JAX
package's fused posts (``canvas_tpu.render._get_program(sig, post)``):
shapes, dtypes and layout exact, odd sizes included; the u8 values may
differ only where ``x ** 0.45`` lands next to a u8 step (torch's and
XLA's pow differ in the last f32 ulp), by at most 1 on at most 0.1% of
values (measured: none on these frames).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import bench
from canvas_tpu import render as ref_render
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.ops import cuda_ops
from canvas_tpu_torch.sources import (SolidColorVideoSource,
                                      VideoColorTransferFilter)

CPU = torch.device('cpu')
W960 = (0, 0, 959, 539)
W1080 = (0, 0, 1919, 1079)


@pytest.fixture(scope='module')
def timeline():
    return timelines.build_timeline(1024)


@pytest.fixture(scope='module')
def ref_timeline():
    return bench.build_timeline(1024)


def _plan(ws, window, start, stop):
    """The port's plan of [start, stop) of *ws* at *window*."""
    planner = port.RenderPlanner(ws, box2i(*window), device='cpu')
    return planner._plan((start, stop))


def _ref_plan(ws, window, start, stop):
    """The JAX package's plan of the same range."""
    window = ref_box2i(*window)
    planner = ref_render.RenderPlanner(ws, window)
    return ref_render.PlanContext(planner, np.arange(start, stop),
                                  window).plan(ws)


def _children(node):
    return [(c.op, c.static, c.children[0].op if c.children else None,
             {k: int(v) for k, v in c.params.items()
              if k in ('dy0', 'dx0')})
            for c in node.children]


# (window, start, stop, what the plan must contain)
EVAL_CASES = {
    'scale_solid_0_1': (W960, 0, 1, 'scale_solid'),
    'dyn_1_5': (W960, 1, 5, 'scale_solid_dyn'),
    'overhang_both_130_134': (W960, 130, 134, 'overhang_both'),
    'empty_children_1000_1003': (W960, 1000, 1003, 'empty'),
    'overhang_bottom_1080p_1000': (W1080, 1000, 1001, 'overhang_bottom'),
}


def _check_structure(node, window, what):
    kids = _children(node)
    assert node.op == 'over_stack' and len(node.static) == 2
    assert kids[0][0] == 'solid_stack' and kids[-1][0] == 'solid_stack'
    placed = [k for k in kids if k[0] == 'placed']
    if what in ('scale_solid', 'scale_solid_dyn'):
        assert [k[2] for k in placed] == [what, what]
    elif what == 'empty':
        assert [k[0] for k in kids[1:-1]] == ['empty', 'empty']
    else:
        H, W = window[3] + 1, window[2] + 1
        over = [(k[3]['dy0'] + k[1][0] > H, k[3]['dx0'] + k[1][1] > W)
                for k in placed]
        want = (True, True) if what == 'overhang_both' else (True, False)
        assert want in over, kids


@pytest.mark.parametrize('case', sorted(EVAL_CASES))
def test_eval_matches_jax(timeline, ref_timeline, case):
    window, start, stop, what = EVAL_CASES[case]
    node = _plan(timeline, window, start, stop)
    _check_structure(node, window, what)
    ref = _ref_plan(ref_timeline, window, start, stop)
    sig = port.signature(node)
    assert sig == ref.signature()
    want = np.asarray(jax.jit(ref_render._make_run(sig, None, jnp, jax))(
        ref.flat_params([])))
    got = port.run(sig, port.params_to_torch(port.flat_params(node), CPU),
                   CPU).numpy()
    assert got.dtype == np.float16 and got.shape == want.shape
    assert got.shape == (stop - start, 4, window[3] + 1, window[2] + 1)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-3)
    equal = np.mean(got.view(np.uint16) == want.view(np.uint16))
    assert equal >= 0.999, equal


@pytest.mark.parametrize('frame', [0, 130, 1000])
def test_render_matches_pull_path(timeline, frame):
    window = box2i(*W960)
    got = port.RenderPlanner(timeline, window, device='cpu').render(
        frame, frame + 1)
    with port_backend.force_backend('numpy'):
        want = np.asarray(timeline.get_frame_f16(frame, window).data,
                          np.float16)
    assert got.shape == (1,) + want.shape and got.dtype == np.float16
    np.testing.assert_allclose(got[0].astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=2e-3)


def test_iter_batches_matches_render(timeline):
    window = box2i(0, 0, 639, 359)
    planner = port.RenderPlanner(timeline, window, device='cpu')
    got = list(planner.iter_batches(0, 10, batch=4))
    # segment [0, 1) renders at its own length; [1, 10) as 4 + 4 + tail
    assert [(s, n) for s, n, _ in got] == [(0, 1), (1, 4), (5, 4), (9, 1)]
    for s, n, out in got:
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float16
        assert tuple(out.shape) == (n, 4, 360, 640)
    streamed = torch.cat([out for _s, _n, out in got]).numpy()
    whole, windows = planner.render(0, 10, with_windows=True)
    assert isinstance(whole, np.ndarray) and whole.shape == (10, 4, 360, 640)
    assert windows.shape == (10, 4) and windows.dtype == np.int64
    np.testing.assert_array_equal(streamed, whole)
    host = list(planner.iter_batches(5, 9, batch=4, device_out=False))
    assert len(host) == 1 and isinstance(host[0][2], np.ndarray)
    np.testing.assert_array_equal(host[0][2], whole[5:9])
    assert planner.render(5, 5).shape == (0, 4, 360, 640)


def test_cpu_runs_no_kernel(timeline):
    before = (cuda_ops.solid_fold.launches, cuda_ops.region_over_sep.launches)
    port.RenderPlanner(timeline, box2i(0, 0, 639, 359),
                       device='cpu').render(100, 102)
    assert (cuda_ops.solid_fold.launches,
            cuda_ops.region_over_sep.launches) == before


def test_params_to_torch(timeline, ref_timeline):
    node = _plan(timeline, W960, 1, 5)
    flat = port.flat_params(node)
    ref = _ref_plan(ref_timeline, W960, 1, 5).flat_params([])
    assert [sorted(p) for p in flat] == [sorted(p) for p in ref]
    for p, q in zip(flat, ref):
        for k in p:
            assert p[k].dtype == q[k].dtype
            np.testing.assert_array_equal(p[k], q[k])
    tparams = port.params_to_torch(flat, CPU)
    seen = set()
    for p in tparams:
        for k, v in p.items():
            # the region offsets too: int32 tensors the kernels read
            assert isinstance(v, torch.Tensor)
            assert v.dtype in (torch.float32, torch.int32, torch.bool)
            if k in ('dy0', 'dx0'):
                assert v.dtype == torch.int32 and v.numel() == 1
            seen.add(k)
    assert {'dy0', 'dx0', 'color', 'box', 'fy', 'tly'} <= seen


def test_out_of_slice_op_raises():
    """The op the port leaves out (no source of the port plans it)
    raises, naming the ROADMAP item that says why; u8_linearize, the
    last op a later slice brought, evaluates
    (tests/test_torch_editor_plugins.py)."""
    for op in ('solid_cells',):
        with pytest.raises(NotImplementedError, match=repr(op) + '.*ROADMAP'):
            port._eval((op, (), (), ()), iter([{}]), CPU)
    with pytest.raises(ValueError, match='unknown op'):
        port._eval(('no_such_op', (), (), ()), iter([{}]), CPU)


# The color filter's ops: 'transfer' (a curve by the f16 bits, all four
# channels) and 'matrix' (3x3 over rgb at full f32). The curves gather
# from tables built with libm's powf where XLA computes the formula, and
# both truncate to the f16 grid: bit-equal. A matrix sums three f32
# products in torch's order and XLA's (which contracts them into fused
# multiply-adds): the f16 frames within 1 f16 ulp, stated per test.

TRANSFER_WINDOW = (0, 0, 255, 143)


def _eval_both(src, ref_src, window, start, stop):
    """(the port's f16 frames, the JAX package's) of [start, stop), each
    package planning its own source; the plans' signatures must agree."""
    node = _plan(src, window, start, stop)
    ref = _ref_plan(ref_src, window, start, stop)
    sig = port.signature(node)
    assert sig == ref.signature()
    want = np.asarray(jax.jit(ref_render._make_run(sig, None, jnp, jax))(
        ref.flat_params([])))
    got = port.run(sig, port.params_to_torch(port.flat_params(node), CPU),
                   CPU).numpy()
    assert got.dtype == np.float16 and got.shape == want.shape
    return node, got, want


def _ulps_f16(a, b):
    """Largest distance of two f16 arrays in f16 steps (finite values)."""
    def order(x):
        bits = x.view(np.int16).astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7fff), bits)
    return int(np.abs(order(a) - order(b)).max())


@pytest.mark.parametrize('curve', color_ops.TRANSFERS)
def test_transfer_matches_jax(timeline, ref_timeline, curve):
    """Each single curve over the headline composite (frames 130..132:
    both scalers and their overhanging regions): bit-equal."""
    node, got, want = _eval_both(
        VideoColorTransferFilter(timeline, curve),
        ref_sources.VideoColorTransferFilter(ref_timeline, curve),
        TRANSFER_WINDOW, 130, 133)
    assert node.op == 'transfer' and node.static == (curve,)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize('transform, ops', [
    ('rgb_to_xyz_sdtv', ['matrix', 'transfer']),
    ('xyz_to_srgb', ['transfer', 'matrix'])])
def test_matrix_matches_jax(timeline, ref_timeline, transform, ops):
    """The two matrix transforms over the headline composite: within 1
    f16 ulp of the JAX package's frames, at least 99.9% bit-equal (the
    3-term sums differ in an f32 ulp, which the f16 store or the curve's
    f16 grid can carry over one step)."""
    node, got, want = _eval_both(
        VideoColorTransferFilter(timeline, transform),
        ref_sources.VideoColorTransferFilter(ref_timeline, transform),
        TRANSFER_WINDOW, 130, 133)
    assert [node.op, node.children[0].op] == ops
    assert np.isfinite(got.astype(np.float32)).all()
    assert _ulps_f16(got, want) <= 1
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.999


def _cards():
    """A composite without scalers: a background, a translucent card with
    animated gain, an animated card."""
    from canvas_tpu_torch.framefuncs import LerpFunc, LinearFrameFunc
    from canvas_tpu_torch.sources import (VideoGainOffsetFilter,
                                          VideoWorkspace)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.3, 0.12, 1.0)), x=0,
           length=64, z=0)
    ws.add(source=VideoGainOffsetFilter(
        SolidColorVideoSource((0.9, 0.2, 0.3, 0.6),
                              window=box2i(5, 4, 40, 30)),
        gain=LinearFrameFunc(0.01, 0.5), offset=0.0), x=0, length=64, z=1)
    ws.add(source=SolidColorVideoSource(
        LerpFunc((0.0, 0.1, 0.9, 0.9), (1.0, 0.8, 0.2, 0.4), 64),
        window=box2i(20, 10, 60, 33)), x=0, length=64, z=2)
    return ws


@pytest.mark.parametrize('transform', color_ops.TRANSFERS + (
    'rgb_to_xyz_sdtv', 'xyz_to_srgb'))
def test_color_filter_matches_pull_path(transform):
    """Every transform of the filter over a composite of solids against
    the NumPy pull path, at test_render.py's assert_matches_pull
    tolerance, 2e-3 (two f16 steps at 1.0), taken relative as well: the
    matrices push this composite's values out to 2.5, where two f16
    steps are 4e-3. (The pull path rounds the composite to f16 before
    the filter and the batched path does not; a matrix row multiplies
    that step by up to 3.2.)"""
    src = VideoColorTransferFilter(_cards(), transform)
    window = box2i(0, 0, 63, 35)
    got = port.RenderPlanner(src, window, device='cpu').render(3, 7)
    want = np.stack([np.asarray(src.get_frame_f16(i, window).data)
                     for i in range(3, 7)])
    assert got.dtype == np.float16 and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=2e-3, atol=2e-3)


def test_transfer_timeline_renders():
    """The config1-like clip (a ramping solid through rec709 -> linear):
    the plan equals the JAX package's for benchmarks.config1's source,
    the frames are bit-equal to its program's and to the pull path's,
    streamed or rendered at once."""
    from canvas_tpu.framefuncs import LerpFunc as RefLerp
    src = timelines.transfer_timeline(1024)
    ref_src = ref_sources.VideoColorTransferFilter(
        ref_sources.SolidColorVideoSource(
            RefLerp((0, 0, 0, 1), (1, 1, 1, 1), 1024)),
        'rec709_to_linear_scene')
    window = (0, 0, 127, 71)
    _node, got, want = _eval_both(src, ref_src, window, 300, 308)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    pull = np.stack([np.asarray(src.get_frame_f16(i, box2i(*window)).data)
                     for i in range(300, 308)])
    np.testing.assert_array_equal(got.view(np.uint16), pull.view(np.uint16))
    planner = port.RenderPlanner(src, box2i(*window), device='cpu')
    streamed = np.concatenate([out.numpy() for _s, _n, out in
                               planner.iter_batches(300, 308, batch=3)])
    np.testing.assert_array_equal(streamed, got)


def test_crossfade_timeline_renders():
    """config2's crossfade (two lerped solids under a lerped mix, which
    the mix peephole plans as one lerped ``solid``): the plan's signature
    equals the JAX package's for benchmarks.config2's source, and the
    frames are bit-equal to its program's at quality 10, to the pull
    path's and streamed."""
    from canvas_tpu.framefuncs import LerpFunc as RefLerp
    src = timelines.crossfade_timeline(1024)
    ref_src = ref_sources.VideoMixFilter(
        ref_sources.SolidColorVideoSource(RefLerp((1, 0, 0, 1), (0, 1, 0, 1),
                                                  1024)),
        ref_sources.SolidColorVideoSource(RefLerp((0, 0, 1, 1), (1, 1, 0, 1),
                                                  1024)),
        RefLerp((0.0,), (1.0,), 1024))
    window = (0, 0, 127, 71)
    node, got, want = _eval_both(src, ref_src, window, 500, 508)
    assert node.op == 'solid'
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    with port_backend.force_backend('numpy'):
        pull = np.stack([np.asarray(src.get_frame_f16(i, box2i(*window)).data)
                         for i in range(500, 508)])
    np.testing.assert_array_equal(got.view(np.uint16), pull.view(np.uint16))
    planner = port.RenderPlanner(src, box2i(*window), device='cpu')
    assert planner.quality == 10
    streamed = np.concatenate([out.numpy() for _s, _n, out in
                               planner.iter_batches(500, 508, batch=3)])
    np.testing.assert_array_equal(streamed, got)


def test_stage_and_dv_recon_ops_match_jax():
    """The two ops no emitter plans, through both ``_eval``s on seeded
    params: 'stage' exactly; 'dv_recon' as 'dv_recon_rows' is held in
    test_torch_mixed.py (the chroma matmul sums in another order, and a
    last-ulp difference before the truncating f16 grid and the transfer
    table moves a value by one f16 step): atol 4e-3, at least 99.9% of
    values equal."""
    rng = np.random.default_rng(5)
    data = rng.uniform(-0.2, 1.2, (2, 4, 9, 11)).astype(np.float16)
    sig = ('stage', (), (), ())
    want = np.asarray(ref_render._eval(sig, iter([{'data': jnp.asarray(data)}]),
                                       jnp, jax))
    got = port._eval(sig, iter([{'data': torch.from_numpy(data)}]), CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

    from canvas_tpu_torch.ops import chroma
    params = {'y': rng.integers(16, 236, (2, 480, 720)).astype(np.uint8),
              'cb': rng.integers(16, 241, (2, 480, 180)).astype(np.uint8),
              'cr': rng.integers(16, 241, (2, 480, 180)).astype(np.uint8),
              'up': np.asarray(chroma._dv_up_matrix(), np.float32),
              'm': np.asarray(chroma.YCBCR_TO_RGB_REC709, np.float32)}
    sig = ('dv_recon', (), (), ())
    want = np.asarray(ref_render._eval(
        sig, iter([{k: jnp.asarray(v) for k, v in params.items()}]), jnp,
        jax)).astype(np.float16)
    got = port._eval(sig, iter([{k: torch.from_numpy(v)
                                 for k, v in params.items()}]),
                     CPU).numpy().astype(np.float16)
    assert got.shape == want.shape == (2, 4, 480, 720)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=4e-3)
    assert np.mean(got.view(np.uint16) == want.view(np.uint16)) >= 0.999


def test_quality_9_raises(timeline, ref_timeline):
    """Quality 9 no longer raises: the acc16 tier renders, bit-equal to
    the JAX package's quality-9 program on the same plan (more ranges in
    test_torch_quality.py)."""
    window = (0, 0, 255, 127)
    planner = port.RenderPlanner(timeline, box2i(*window), quality=9,
                                 device='cpu')
    got = planner.render(128, 131)
    ref = ref_render.RenderPlanner(ref_timeline, ref_box2i(*window),
                                   quality=9)
    want = np.asarray(ref.render(128, 131))
    assert got.dtype == np.float16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize('kw', [{'mesh': object()}, {'max_inflight': 2}])
def test_iter_batches_unported_options_raise(timeline, kw):
    """A ``mesh`` that is not a ``mesh.Mesh`` raises (a real mesh:
    test_torch_sharded.py); ``max_inflight`` no longer does: it paces
    the stream and leaves the frames as they were (more in
    test_torch_replay.py)."""
    planner = port.RenderPlanner(timeline, box2i(0, 0, 255, 127),
                                 device='cpu')
    if 'mesh' in kw:
        with pytest.raises(TypeError, match='Mesh'):
            next(planner.iter_batches(0, 4, batch=4, **kw))
    else:
        _s, _n, want = next(planner.iter_batches(0, 4, batch=4))
        _s, _n, got = next(planner.iter_batches(0, 4, batch=4, **kw))
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match='post'):
        next(planner.iter_batches(0, 4, batch=4, post='rgb24'))


# (window, start, stop): odd height and width; odd height only; 1080p
POST_CASES = {'odd_321x181': ((0, 0, 320, 180), 128, 131),
              'odd_h_640x359': ((0, 0, 639, 358), 1, 3),
              '1080p': (W1080, 1000, 1001)}


@pytest.mark.parametrize('post', ['rgba_u8', 'bgra_u8', 'yuv420'])
@pytest.mark.parametrize('case', sorted(POST_CASES))
def test_iter_batches_post_matches_jax(timeline, ref_timeline, case, post):
    window, start, stop = POST_CASES[case]
    H, W = window[3] + 1, window[2] + 1
    B = stop - start
    ref = _ref_plan(ref_timeline, window, start, stop)
    want = np.asarray(ref_render._get_program(ref.signature(), post)(
        ref.flat_params([])))
    planner = port.RenderPlanner(timeline, box2i(*window), device='cpu')
    got = [out for _s, _n, out in planner.iter_batches(start, stop,
                                                       batch=B, post=post)]
    assert len(got) == 1
    got = got[0]
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    size = (H, W * 4) if post != 'yuv420' else (
        H * W + 2 * ((H + 1) // 2) * ((W + 1) // 2),)
    assert tuple(got.shape) == (B,) + size == want.shape
    got = got.numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print('%s %s: max |diff| %d, share %.3g' % (case, post, diff.max(),
                                                 np.mean(diff != 0)))
    assert diff.max() <= 1 and np.mean(diff != 0) <= 1e-3, (
        diff.max(), np.mean(diff != 0))


def test_default_device_is_cuda_and_raises_without_it(timeline):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        port.RenderPlanner(timeline, box2i(*W960))
    with pytest.raises(RuntimeError, match='CUDA'):
        port.RenderPlanner(timeline, box2i(*W960), device='cuda')


def test_planner_pins_quality_10_math(timeline):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        port.RenderPlanner(timeline, box2i(*W960), device='cpu')
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == 'highest'
    finally:
        torch.backends.cudnn.allow_tf32 = True
