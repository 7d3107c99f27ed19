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
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
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
    want = np.asarray(timeline.get_frame_f16(frame, window).data, np.float16)
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
            if k in ('dy0', 'dx0'):
                assert type(v) is int
            else:
                assert isinstance(v, torch.Tensor)
                assert v.dtype in (torch.float32, torch.int32, torch.bool)
            seen.add(k)
    assert {'dy0', 'dx0', 'color', 'box', 'fy', 'tly'} <= seen


def test_out_of_slice_op_raises():
    src = VideoColorTransferFilter(
        SolidColorVideoSource((0.25, 0.5, 0.75, 1.0)), 'linear_to_rec709')
    planner = port.RenderPlanner(src, box2i(0, 0, 31, 31), device='cpu')
    with pytest.raises(NotImplementedError, match="'transfer'.*ROADMAP"):
        planner.render(0, 2)


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
    planner = port.RenderPlanner(timeline, box2i(0, 0, 255, 127),
                                 device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        next(planner.iter_batches(0, 4, batch=4, **kw))
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
