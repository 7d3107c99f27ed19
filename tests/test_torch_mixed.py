"""The port's mixed-content slice against the JAX package, on the CPU:
DV clips through animated scalers and host-staged sources. The JAX side
gets the JAX package's timeline (``benchmarks._mixed_timeline``) and
classes; the port gets its own (``canvas_tpu_torch.timelines``), built
from the same code and seeds.

Covered: the new ``_eval`` ops on nodes planned once by ``canvas_tpu``
(their params ``np.asarray``'d into the port); the port's staging
(``SlabStager``, ``PlanContext.stage``, the DV plane stack and its row
map); the port's ``PlanContext`` across derived contexts; signatures of
nodes that hold device tensors; and the whole slice at 1920x1080.

Tolerances:

- One op on the same inputs: f32 values within atol 4e-3 with at least
  99.9% of values equal after rounding to f16. The DV chroma upsample
  and the scalers are f32 matmuls summed in another order than XLA's on
  this CPU; a last-ulp difference before the truncating f16 grid and
  the transfer LUT moves a value by one f16 step (2e-3 below 2.0, 4e-3
  below 4.0). A placed region over a zero base is checked the same way.
- Rendered frames (f16) against ``canvas_tpu.render`` on CPU JAX and
  against the NumPy pull path: atol 1e-2 with at least 99% of values
  bit-equal, the tolerance of test_render.py::test_dv_recon_batched.
- A host-staged graph: bit-equal to both (the staged frames are the
  pull path's own f16 frames, composited by the same f32 math).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import benchmarks
from canvas_tpu import coded as ref_coded
from canvas_tpu import framefuncs as ref_framefuncs
from canvas_tpu import frames as ref_frames
from canvas_tpu import render as ref_render
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import coded as port_coded
from canvas_tpu_torch import framefuncs as port_framefuncs
from canvas_tpu_torch import frames as port_frames
from canvas_tpu_torch import plan as port_plan
from canvas_tpu_torch import render as port
from canvas_tpu_torch import sources as port_sources
from canvas_tpu_torch import staging, timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ops import cuda_ops

CPU = torch.device('cpu')
W540 = (0, 0, 959, 539)
W1080 = (0, 0, 1919, 1079)

#: Each package's modules, so a graph builds the same from either.
REF = dict(box2i=ref_box2i, coded=ref_coded, framefuncs=ref_framefuncs,
           frames=ref_frames, sources=ref_sources)
PORT = dict(box2i=box2i, coded=port_coded, framefuncs=port_framefuncs,
            frames=port_frames, sources=port_sources)


@pytest.fixture(scope='module')
def mixed():
    return timelines.mixed_timeline(256)


@pytest.fixture(scope='module')
def ref_mixed():
    return benchmarks._mixed_timeline(256)


def _walk(node, out=None):
    out = [] if out is None else out
    out.append(node)
    for c in node.children:
        _walk(c, out)
    return out


def _ref_plan(source, window, start, stop):
    """A segment planned by canvas_tpu (staging through JAX on the CPU)."""
    window = ref_box2i(*window)
    planner = ref_render.RenderPlanner(source, window)
    planner.stage_cache_mb = 0
    return ref_render.PlanContext(planner, np.arange(start, stop),
                                  window).plan(source)


def _port_plan(source, window, start, stop, **kw):
    window = box2i(*window)
    planner = port.RenderPlanner(source, window, device='cpu', **kw)
    return port_plan.PlanContext(planner, np.arange(start, stop),
                                 window).plan(source), planner


def _f16_close(got, want, atol, share):
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=atol)
    g16, w16 = got.astype(np.float16), want.astype(np.float16)
    equal = np.mean(g16.view(np.uint16) == w16.view(np.uint16))
    assert equal >= share, equal


def _custom(lib):
    """A source with no emit, on *lib*'s VideoSource: the planner
    host-stages it."""

    class Custom(lib['frames'].VideoSource):
        def __init__(self):
            self.pulls = []

        def _render_f16(self, frame_index, frame):
            self.pulls.append(frame_index)
            h, w = frame.full_window.height, frame.full_window.width
            rng = np.random.RandomState(frame_index)
            data = (rng.rand(4, h, w) * 0.9).astype(np.float16)
            data[3] = 0.75
            frame.data = data
            frame.current_window = frame.full_window

    return Custom()


def _staged_graph(lib=PORT):
    src = lib['sources']
    ws = src.VideoWorkspace()
    ws.add(source=src.SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)), x=0,
           length=64, z=0)
    custom = _custom(lib)
    ws.add(source=custom, x=0, length=64, z=1)
    return ws, custom


# (op, segment, window): the first node of that op in the plan of the
# mixed timeline; 'placed' is the first placed region that is not a
# factored solid, evaluated as the only child of an over_stack.
OP_CASES = {
    'scale': ('scale', (0, 1), W540),
    'scale_taps_dyn': ('scale_taps_dyn', (1, 3), W540),
    'place': ('place', (1, 3), W540),
    'dv_recon_rows': ('dv_recon_rows', (1, 3), W540),
    'placed_region': ('placed', (1, 3), W540),
    'stage_rows': ('stage_rows', (3, 6), (0, 0, 255, 127)),
}


@pytest.mark.parametrize('case', sorted(OP_CASES))
def test_op_matches_jax(ref_mixed, case):
    op, (start, stop), window = OP_CASES[case]
    source = _staged_graph(REF)[0] if op == 'stage_rows' else ref_mixed
    node = _ref_plan(source, window, start, stop)
    pick = [n for n in _walk(node) if n.op == op
            and not (op == 'placed'
                     and n.children[0].op.startswith('scale_solid'))][0]
    if op == 'placed':
        pick = ref_render.Node('over_stack',
                               static=(window[3] + 1, window[2] + 1),
                               children=[pick])
    sig = pick.signature()
    params = pick.flat_params([])
    want = np.asarray(ref_render._eval(sig, iter(params), jnp, jax))
    tparams = port.params_to_torch(
        [{k: np.asarray(v) for k, v in p.items()} for p in params], CPU)
    launches = cuda_ops.region_over.launches
    got = port._eval(sig, iter(tparams), CPU).numpy()
    assert cuda_ops.region_over.launches == launches
    assert got.dtype == np.float32 and got.shape == want.shape
    if op == 'stage_rows':
        np.testing.assert_array_equal(got, want)
    else:
        _f16_close(got, want, 4e-3, 0.999)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize('pipelined', [False, True])
def test_stager_stacks_equal_host(monkeypatch, pipelined):
    if pipelined:
        monkeypatch.setattr(staging, 'SLAB_BYTES', 1)
    rng = np.random.default_rng(71)
    specs = [((3, 5), np.uint8), ((2, 4), np.float16)]
    stager = staging.SlabStager(specs, 13, CPU)
    assert stager.n_total == 16 and stager.pipelined == pipelined
    rows = [(rng.integers(0, 256, (3, 5)).astype(np.uint8),
             rng.uniform(0, 1, (2, 4)).astype(np.float16))
            for _ in range(13)]
    for n, row in enumerate(rows):
        for s, r in zip(stager.host, row):
            s[n] = r
        stager.note_row(n)
    stacks = stager.finish()
    assert [s.dtype for s in stacks] == [torch.uint8, torch.float16]
    for k, (stack, host) in enumerate(zip(stacks, stager.host)):
        got = stack.numpy()
        assert got.shape == (16,) + specs[k][0]
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got[:13], [r[k] for r in rows])
        for pad in range(13, 16):          # padding repeats the last row
            np.testing.assert_array_equal(got[pad], rows[-1][k])


def test_stager_refuses_a_mesh():
    """A mesh must be a ``mesh.Mesh``: anything else is refused before a
    byte is staged (staging onto a real mesh: test_torch_sharded.py)."""
    with pytest.raises(TypeError, match='Mesh'):
        staging.SlabStager([((2,), np.uint8)], 1, CPU, mesh=object())


def test_dv_plane_stack_matches_jax(mixed, ref_mixed):
    ref = _ref_plan(ref_mixed, W540, 1, 11)
    got, _planner = _port_plan(mixed, W540, 1, 11)
    ref_nodes = [n for n in _walk(ref) if n.op == 'dv_recon_rows']
    got_nodes = [n for n in _walk(got) if n.op == 'dv_recon_rows']
    assert len(got_nodes) == len(ref_nodes) == 3
    for r, g in zip(ref_nodes, got_nodes):
        np.testing.assert_array_equal(g.params['rows'], r.params['rows'])
        for k in ('py', 'pcb', 'pcr'):
            assert isinstance(g.params[k], torch.Tensor)
            np.testing.assert_array_equal(g.params[k].numpy(),
                                          np.asarray(r.params[k]))
        assert g.params['py'].shape[0] == 16       # 10 frames padded to 8s
    assert port.signature(got) == ref.signature()


def test_plan_context_keeps_its_class(mixed):
    window = box2i(*W540)
    planner = port.RenderPlanner(mixed, window, device='cpu')
    frames = np.arange(4, 8)
    ctx = port_plan.PlanContext(planner, frames, window)
    base = ref_render.PlanContext(planner, frames, window)
    box = box2i(0, 0, 127, 63)
    sem = np.tile([0, 0, 99, 49], (4, 1))
    for name, args in (('with_frames', (frames + 3,)),
                       ('with_window', (box,)),
                       ('with_window', (box, 'keep')),
                       ('with_window', (box, sem)),
                       ('with_sem', (sem,))):
        got = getattr(ctx, name)(*args)
        want = getattr(base, name)(*args)
        assert type(got) is port_plan.PlanContext, name
        assert vars(got).keys() == vars(want).keys()
        for k in vars(want):
            np.testing.assert_array_equal(np.asarray(vars(got)[k],
                                                     dtype=object),
                                          np.asarray(vars(want)[k],
                                                     dtype=object))
    nested = ctx.with_frames(frames).with_window(box, 'keep').with_sem(sem)
    assert type(nested) is port_plan.PlanContext


def test_signature_of_device_tensors_matches_canvas():
    rng = np.random.default_rng(73)
    planes = {k: rng.integers(0, 256, (8, 6, s)).astype(np.uint8)
              for k, s in (('py', 12), ('pcb', 3), ('pcr', 3))}
    rows = np.arange(5, dtype=np.int32)

    def node(stacks):
        recon = ref_render.Node('dv_recon_rows', params=dict(
            stacks, rows=rows, up=np.zeros((12, 3), np.float32),
            m=np.eye(3, dtype=np.float32)))
        return ref_render.Node('place', static=(64, 128, 0, 5, 0, 11, 0, 0),
                               children=[recon])

    host = node(planes)
    dev = node({k: torch.from_numpy(v) for k, v in planes.items()})
    with pytest.raises(TypeError):
        dev.signature()                 # canvas_tpu's: NumPy dtypes only
    assert port.signature(dev) == host.signature() == port.signature(host)
    assert (port.sliced_signature(dev, 5, 2)
            == ref_render._sliced_signature(host, 5, 2))
    flat = port.flat_params(dev)
    assert flat[1]['py'] is dev.children[0].params['py']
    tparams = port.params_to_torch(flat, CPU)
    assert tparams[1]['py'] is dev.children[0].params['py']
    assert isinstance(tparams[1]['rows'], torch.Tensor)


def test_host_staged_graph_matches_jax_and_pull():
    ws, src = _staged_graph()
    node, _planner = _port_plan(ws, (0, 0, 255, 127), 2, 9)
    assert 'stage_rows' in [n.op for n in _walk(node)]
    window = box2i(0, 0, 255, 127)
    got = port.RenderPlanner(ws, window, device='cpu').render(2, 9)
    assert sorted(src.pulls) == sorted(list(range(2, 9)) * 2)  # 2 plans
    want = np.asarray(ref_render.render_frames(
        _staged_graph(REF)[0], ref_box2i(0, 0, 255, 127), 2, 9))
    np.testing.assert_array_equal(got, want)
    for i in (2, 8):
        with port_backend.force_backend('numpy'):
            pull = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        np.testing.assert_array_equal(got[i - 2], pull)


def test_stage_cache_replays_and_can_be_disabled():
    ws, src = _staged_graph()
    window = box2i(0, 0, 127, 63)
    planner = port.RenderPlanner(ws, window, device='cpu')
    first = planner.render(0, 8)
    assert sorted(src.pulls) == list(range(8))
    second = planner.render(0, 8)
    assert len(src.pulls) == 8              # replayed from the cache
    np.testing.assert_array_equal(first, second)
    assert len(planner.persistent_cache) == 1
    planner = port.RenderPlanner(ws, window, device='cpu')
    planner.stage_cache_mb = 0
    planner.render(0, 8)
    planner.render(0, 8)
    assert len(src.pulls) == 24 and len(planner.persistent_cache) == 0


@pytest.fixture(scope='module')
def mixed_1080p(mixed):
    """Frames 0..3 of the mixed timeline at 1080p through the port on the
    CPU: segment [0, 1) plans static ``scale``, [1, 4) ``scale_taps_dyn``."""
    planner = port.RenderPlanner(mixed, box2i(*W1080), device='cpu')
    launches = (cuda_ops.solid_fold.launches,
                cuda_ops.region_over_sep.launches,
                cuda_ops.region_over.launches)
    got = planner.render(0, 4)
    assert launches == (cuda_ops.solid_fold.launches,
                        cuda_ops.region_over_sep.launches,
                        cuda_ops.region_over.launches)
    return got


def test_mixed_timeline_plans_every_kernel_path(mixed):
    for (start, stop), scaler in (((0, 1), 'scale'),
                                  ((1, 4), 'scale_taps_dyn')):
        node, _planner = _port_plan(mixed, W1080, start, stop)
        kids = node.children
        assert node.op == 'over_stack'
        assert [c.op for c in kids].count('solid_stack') == 2
        regions = [c.children[0].op for c in kids if c.op == 'placed']
        assert regions.count(scaler) == 3
        assert len([r for r in regions if r.startswith('scale_solid')]) == 1


def test_mixed_timeline_1080p_matches_jax(ref_mixed, mixed_1080p):
    want = np.asarray(ref_render.render_frames(ref_mixed,
                                               ref_box2i(*W1080), 0, 4))
    assert mixed_1080p.dtype == np.float16
    assert mixed_1080p.shape == (4, 4, 1080, 1920)
    _f16_close(mixed_1080p, want, 1e-2, 0.99)


@pytest.mark.parametrize('frame', [0, 3])
def test_mixed_timeline_1080p_matches_pull(mixed, mixed_1080p, frame):
    with port_backend.force_backend('numpy'):
        pull = np.asarray(mixed.get_frame_f16(frame, box2i(*W1080)).data,
                          np.float16)
    _f16_close(mixed_1080p[frame], pull, 1e-2, 0.99)


def _rolled(lib):
    """Seeded 720x480 4:1:1 planes, rolled by the frame index, on *lib*'s
    CodedImageSource."""

    class Rolled(lib['coded'].CodedImageSource):
        def __init__(self):
            rng = np.random.RandomState(79)
            self.planes = (
                rng.randint(16, 236, (480, 720)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8),
                rng.randint(16, 241, (480, 180)).astype(np.uint8))
            self.decodes = 0

        def get_frame(self, frame_index, quality=0):
            self.decodes += 1
            return lib['coded'].CodedImage([np.roll(p, frame_index, axis=0)
                                            for p in self.planes])

    return Rolled()


def _small_dv_graph(lib):
    rolled = _rolled(lib)
    src = lib['sources']
    clip = src.VideoScaler(
        lib['coded'].DVReconstructionFilter(rolled),
        target_point=lib['framefuncs'].LerpFunc((100, 50), (400, 200), 16),
        source_point=(0.0, -1.0), scale_factors=(0.5, 0.5),
        source_rect=lib['box2i'](0, -1, 719, 478))
    ws = src.VideoWorkspace()
    ws.add(source=src.SolidColorVideoSource((0.2, 0.3, 0.4, 1.0)), x=0,
           length=16, z=0)
    ws.add(source=clip, x=0, length=16, z=1)
    return ws, rolled


def test_small_dv_graph_matches_jax_and_pull():
    """A 1280x720 workspace with one DV clip scaled 0.5 and animated: a
    placed region over a solid background."""
    ws, rolled = _small_dv_graph(PORT)
    node, _planner = _port_plan(ws, (0, 0, 1279, 719), 2, 5)
    placed = [c for c in node.children if c.op == 'placed']
    assert placed and placed[0].children[0].op == 'scale_taps_dyn'
    window = box2i(0, 0, 1279, 719)
    planner = port.RenderPlanner(ws, window, device='cpu')
    got = np.concatenate([out for _s, _n, out in planner.iter_batches(
        2, 5, batch=2, device_out=False)])
    assert rolled.decodes > 0
    want = np.asarray(ref_render.render_frames(
        _small_dv_graph(REF)[0], ref_box2i(0, 0, 1279, 719), 2, 5))
    _f16_close(got, want, 1e-2, 0.99)
    for i in (2, 4):
        with port_backend.force_backend('numpy'):
            pull = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        _f16_close(got[i - 2], pull, 1e-2, 0.99)
