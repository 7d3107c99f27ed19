"""The port's multi-device rendering (``canvas_tpu_torch.mesh``,
``iter_batches(mesh=, axis=)``, ``render_sharded``, mesh staging and
``write_video(mesh=)``) against the JAX package's, on the CPU.

The JAX package shards over the virtual CPU devices ``tests/conftest.py``
sets up (``--xla_force_host_platform_device_count=8``); PyTorch has no
such flag, so the port's mesh names the ``cpu`` device once per entry,
each entry one shard (``mesh.Mesh``'s docstring). Every test runs the
same timeline through ``canvas_tpu.render`` over the first n virtual
devices and through the port over a mesh of n ``cpu`` entries, for n =
2, 4 and 8 (the frames x space cases: 1x2, 2x2 and 2x4).

Tolerances are the JAX tests' own: ``assert_array_equal`` where they
assert it (sharded against unsharded, test_render.py:749, :783, :976),
``atol=2e-3`` against the pull path where they do (:301, :365, :917,
:949). Besides, every solid and composite case here is bit-equal to the
JAX package's sharded output and to the port's unsharded output; the
mixed-content timeline (DV planes staged onto the mesh) is bit-equal to
the port's unsharded render. ``write_video(mesh=)`` packets are
byte-equal to the port's unsharded ``write_video`` with
``CANVAS_AV_THREADS=1``.
"""

import numpy as np
import pytest

import jax
import torch
from jax.sharding import Mesh as JaxMesh

import canvas_tpu.process as ref_process
from canvas_tpu import render as ref_render
from canvas_tpu_torch import backend, libav, mesh as port_mesh
from canvas_tpu_torch import process as port_process
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.mesh import Mesh, Replicated, ShardedFrames

CPU = torch.device('cpu')
WINDOW = (0, 0, 31, 31)
WIN = box2i(*WINDOW)
SHARDS = [2, 4, 8]
#: (frames, space) shapes of 2, 4 and 8 entries
GRIDS = [(1, 2), (2, 2), (2, 4)]


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        raise AssertionError('tests/conftest.py sets up 8 virtual devices; '
                             'found %d' % len(jax.devices()))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _port_mesh(shape, names):
    return Mesh(np.full(shape, 'cpu', dtype=object), names)


def _pull(source, window, start, stop):
    with backend.force_backend('numpy'):
        return np.stack([np.asarray(source.get_frame_f16(
            i, box2i(*window)).data, np.float16) for i in range(start, stop)])


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def _near_pull(got, want):
    np.testing.assert_allclose(np.asarray(got).astype(np.float32),
                               want.astype(np.float32), atol=2e-3)


# --- graphs, built the same from either package ------------------------------

def _lerp_over_card(P, n=16):
    ws = P.VideoWorkspace()
    ws.add(source=P.SolidColorVideoSource(
        P.LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), n)), x=0, length=n, z=0)
    ws.add(source=P.SolidColorVideoSource((0, 0, 1, 0.5),
                                          window=P.box2i(4, 4, 20, 20)),
           x=0, length=n, z=1)
    return ws


def _ramp_card(P):
    """test_render.py:749's workspace: a solid under a ramping card."""
    ws = P.VideoWorkspace()
    ws.add(source=P.SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)),
           x=0, length=64, z=0)
    ws.add(source=P.SolidColorVideoSource(
        P.LerpFunc((1, 0, 0, 0.5), (0, 1, 0, 0.5), 64),
        window=P.box2i(8, 8, 63, 63)), x=0, length=64, z=1)
    return ws


def _one_ramp(P, n):
    ws = P.VideoWorkspace()
    ws.add(source=P.SolidColorVideoSource(
        P.LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), n)), x=0, length=n, z=0)
    return ws


def _two_cuts(P):
    """test_render.py:917's: structure cuts at frames 10 and 17."""
    ws = P.VideoWorkspace()
    ws.add(source=P.SolidColorVideoSource(
        P.LerpFunc((1, 0, 0, 1), (0, 1, 0, 1), 23)), x=0, length=23, z=0)
    ws.add(source=P.SolidColorVideoSource((0, 0, 1, 0.5),
                                          window=P.box2i(4, 4, 20, 20)),
           x=10, length=7, z=1)
    return ws


def _gray_ramp(P, n):
    ws = P.VideoWorkspace()
    ws.add(source=P.SolidColorVideoSource(
        P.LerpFunc((0, 0, 0, 1), (1, 1, 1, 1), n)), x=0, length=n, z=0)
    return ws


# --- the mesh ----------------------------------------------------------------

def test_mesh_shape_hash_and_distinct_devices():
    m = _port_mesh((2, 4), ('frames', 'space'))
    assert dict(m.shape) == {'frames': 2, 'space': 4} and m.size == 8
    assert m.distinct_devices() == [CPU]
    assert m.axis_devices('frames') == [CPU, CPU]
    assert m == _port_mesh((2, 4), ('frames', 'space'))
    assert hash(m) == hash(_port_mesh((2, 4), ('frames', 'space')))
    assert m != _port_mesh((4, 2), ('frames', 'space'))
    assert m != _port_mesh((2, 4), ('space', 'frames'))
    assert {m: 1}[_port_mesh((2, 4), ('frames', 'space'))] == 1
    assert "'frames': 2" in repr(m)
    with pytest.raises(ValueError, match='axis name'):
        Mesh(['cpu', 'cpu'], ('frames', 'space'))


def test_mesh_naming_an_absent_card_raises(monkeypatch):
    """No fallback: a CUDA entry needs that card (here there is none, and
    with CUDA faked present, cuda:3 of one card is still refused)."""
    with pytest.raises(RuntimeError, match='CUDA'):
        Mesh(['cuda:0', 'cuda:0'], ('frames',))
    with pytest.raises(RuntimeError, match='CUDA'):
        port_mesh.local_mesh()
    with pytest.raises(RuntimeError, match='CUDA'):
        port.render_sharded(_ramp_card(port_process), WIN, 0, 2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='1 CUDA device'):
        Mesh(['cuda:0', 'cuda:3'], ('frames',))
    with pytest.raises(ValueError, match='cpu or cuda'):
        Mesh(['meta'], ('frames',))


def test_to_device_replicates_onto_each_distinct_device():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    r = backend.to_device(a, _port_mesh((4,), ('frames',)))
    assert isinstance(r, Replicated) and list(r.copies) == [CPU]
    assert tuple(r.shape) == (3, 4) and r.dtype == torch.float32
    np.testing.assert_array_equal(r.on(CPU).numpy(), a)
    assert r.nbytes == a.nbytes


def test_sharded_frames_slice_gather_and_reshard():
    rng = np.random.default_rng(5)
    whole = torch.from_numpy(rng.uniform(0, 1, (6, 4, 5, 3)).astype(
        np.float16))
    m = _port_mesh((2, 2), ('frames', 'space'))
    out = ShardedFrames([(whole[:3], (slice(0, 3),)),
                         (whole[3:], (slice(3, 6),))], whole.shape,
                        whole.dtype, port_mesh.Sharding(m, ('frames',)))
    _same(out, whole.numpy())
    _same(out[:4], whole[:4].numpy())
    _same(out[2:5], whole[2:5].numpy())
    both = ShardedFrames.concatenate([out, out[1:2]])
    _same(both, np.concatenate([whole.numpy(), whole[1:2].numpy()]))
    rs = both.reshard(m, 'frames', 'space')
    assert 'space' in str(rs.sharding) and len(rs.shards) == 4
    assert [tuple(t.shape) for t, _b in rs.shards] == [
        (4, 4, 3, 3), (4, 4, 2, 3), (3, 4, 3, 3), (3, 4, 2, 3)]
    _same(rs, both.numpy())
    _same(backend.to_host(rs).numpy(), both.numpy())


# --- render_sharded and iter_batches(mesh=) against the JAX package ----------

@pytest.mark.parametrize('n', SHARDS)
def test_render_sharded_matches(n):
    """test_render.py:301: render_sharded against the pull path."""
    want = _pull(_lerp_over_card(port_process), WINDOW, 0, 16)
    got = port.render_sharded(_lerp_over_card(port_process), WIN, 0, 16,
                              mesh=_port_mesh((n,), ('frames',)))
    _near_pull(got, want)
    ref = ref_render.render_sharded(_lerp_over_card(ref_process),
                                    ref_process.box2i(*WINDOW), 0, 16,
                                    mesh=_jax_mesh((n,), ('frames',)))
    _same(got, ref)
    _same(got, port.render_frames(_lerp_over_card(port_process), WIN, 0,
                                  16, device='cpu'))


@pytest.mark.parametrize('n', SHARDS)
def test_iter_batches_sharded_matches(n):
    """test_render.py:749: frame-sharded streaming equals unsharded, and
    the output is sharded over the frame axis."""
    window = (0, 0, 127, 95)
    planner = port.RenderPlanner(_ramp_card(port_process), box2i(*window),
                                 device='cpu')
    want = planner.render(0, 32)
    mesh = _port_mesh((n,), ('frames',))
    chunks = list(planner.iter_batches(0, 32, batch=16, device_out=False,
                                       mesh=mesh))
    got = np.concatenate([o for (_s, _n, o) in chunks], axis=0)
    _same(got, want)
    (_s, _n, out), = planner.iter_batches(0, 16, batch=16, mesh=mesh)
    assert isinstance(out, ShardedFrames)
    assert 'frames' in str(out.sharding)
    assert len(out.shards) == n and out.devices() == [CPU] * n
    assert [b[0] for _t, b in out.shards] == [
        (i * 16 // n, (i + 1) * 16 // n) for i in range(n)]
    ref = ref_render.RenderPlanner(_ramp_card(ref_process),
                                   ref_process.box2i(*window))
    ref_chunks = list(ref.iter_batches(0, 32, batch=16, device_out=False,
                                       mesh=_jax_mesh((n,), ('frames',))))
    _same(got, np.concatenate([np.asarray(o) for (_s, _n, o) in ref_chunks]))


@pytest.mark.parametrize('grid', GRIDS)
def test_render_sharded_spatial_axis(grid):
    """test_render.py:365 and :783: a frames x space mesh reshards rows
    over the space axis, with the 5-frame tail padded and sliced back."""
    names = ('frames', 'space')
    mesh = _port_mesh(grid, names)
    src = _one_ramp(port_process, 8)
    for stop in (8, 5):
        got = port.render_sharded(src, WIN, 0, stop, mesh=mesh,
                                  spatial_axis='space', device_out=True)
        assert 'space' in str(got.sharding) and got.shape[0] == stop
        assert len(got.shards) == grid[0] * grid[1]
        fb, rb = -(-stop // grid[0]), 32 // grid[1]
        for k, (t, b) in enumerate(got.shards):
            i, j = divmod(k, grid[1])
            assert b[0] == (min(i * fb, stop), min((i + 1) * fb, stop))
            assert b[2] == (j * rb, (j + 1) * rb)
        _near_pull(got, _pull(src, WINDOW, 0, stop))
        _same(got, port.render_frames(src, WIN, 0, stop, device='cpu'))
        ref = ref_render.render_sharded(
            _one_ramp(ref_process, 8), ref_process.box2i(*WINDOW), 0, stop,
            mesh=_jax_mesh(grid, names), spatial_axis='space')
        _same(got, ref)
    solid = port_process.VideoWorkspace()
    solid.add(source=port_process.SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
              x=0, length=32, z=0)
    window = box2i(0, 0, 127, 63)
    out = port.render_sharded(solid, window, 0, 4, mesh=mesh, axis='frames',
                              device_out=True, spatial_axis='space')
    _same(out, port.render_frames(solid, window, 0, 4, device='cpu'))


@pytest.mark.parametrize('n', SHARDS)
def test_render_sharded_segment_cuts_and_tail_padding(n):
    """test_render.py:917: across structure cuts with frame counts that do
    not divide the shards; device_out across the cuts."""
    src = _two_cuts(port_process)
    mesh = _port_mesh((n,), ('frames',))
    want = _pull(src, WINDOW, 0, 23)
    got = port.render_sharded(src, WIN, 0, 23, mesh=mesh)
    assert got.shape[0] == 23
    _near_pull(got, want)
    dev = port.render_sharded(src, WIN, 0, 23, mesh=mesh,
                              device_out=True)
    assert isinstance(dev, ShardedFrames) and len(dev.shards) == n
    _near_pull(dev, want)
    _same(dev, got)
    _same(got, port.render_frames(src, WIN, 0, 23, device='cpu'))
    ref = ref_render.render_sharded(_two_cuts(ref_process),
                                    ref_process.box2i(*WINDOW), 0, 23,
                                    mesh=_jax_mesh((n,), ('frames',)))
    _same(got, ref)


@pytest.mark.parametrize('n', SHARDS)
def test_iter_batches_sharded_small_segment(n):
    """test_render.py:949: a segment smaller than the batch and not
    divisible by the shards pads to the shard count and slices back."""
    src = _gray_ramp(port_process, 5)
    planner = port.RenderPlanner(src, box2i(*WINDOW), device='cpu')
    got = [(s, k, o) for s, k, o in planner.iter_batches(
        0, 5, batch=8, mesh=_port_mesh((n,), ('frames',)), device_out=False)]
    assert [(s, k) for s, k, _o in got] == [(0, 5)]
    assert got[0][2].shape[0] == 5
    _near_pull(got[0][2], _pull(src, WINDOW, 0, 5))
    _same(got[0][2], planner.render(0, 5))
    ref = ref_render.RenderPlanner(_gray_ramp(ref_process, 5),
                                   ref_process.box2i(*WINDOW))
    (_s, k, want), = ref.iter_batches(0, 5, batch=8, device_out=False,
                                      mesh=_jax_mesh((n,), ('frames',)))
    _same(got[0][2], np.asarray(want)[:k])


@pytest.mark.parametrize('n', SHARDS)
def test_iter_batches_sharded_post_u8(n):
    """test_render.py:976's sharded arm: post='rgba_u8' over a mesh
    equals the unsharded post, and the JAX package's sharded post."""
    src = _gray_ramp(port_process, 12)
    mesh = _port_mesh((n,), ('frames',))
    planner = port.RenderPlanner(src, box2i(*WINDOW), device='cpu')
    sharded = [np.asarray(u8)[:k] for (_s, k, u8) in planner.iter_batches(
        0, 8, batch=8, mesh=mesh, post='rgba_u8')]
    plain = [np.asarray(u8)[:k] for (_s, k, u8) in planner.iter_batches(
        0, 8, batch=8, post='rgba_u8')]
    got = np.concatenate(sharded)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.concatenate(plain))
    ref = ref_render.RenderPlanner(_gray_ramp(ref_process, 12),
                                   ref_process.box2i(*WINDOW))
    want = [np.asarray(u8)[:k] for (_s, k, u8) in ref.iter_batches(
        0, 8, batch=8, mesh=_jax_mesh((n,), ('frames',)), post='rgba_u8')]
    np.testing.assert_array_equal(got, np.concatenate(want))


def _guard_case(P):
    src = P.VideoSequence()
    src.append((P.SolidColorVideoSource((1, 0, 0, 1)), 0, 8))
    src.append((P.SolidColorVideoSource((0, 0, 1, 1)), 0, 8))
    return src


@pytest.mark.parametrize('n', SHARDS)
def test_hbm_guard_sharded(monkeypatch, n):
    """test_render.py:2025's sharded arm (CANVAS_HBM_MB=2, 192x108): the
    JAX guard divides the footprint by the shard count. The port holds
    each distinct device to its own share: n distinct cards pass (or
    not) where JAX's n devices do, while n entries of ONE device hold
    all n shards there and must not pass."""
    window = (0, 0, 191, 107)
    monkeypatch.setenv('CANVAS_HBM_MB', '2')
    with pytest.raises(ValueError, match='HBM budget'):
        port.RenderPlanner(_guard_case(port_process), box2i(*window),
                           device='cpu').render(0, 16)
    try:
        ref_render.render_sharded(
            ref_process.SolidColorVideoSource((0, 1, 0, 1)),
            ref_process.box2i(*window), 0, 16,
            mesh=_jax_mesh((n,), ('frames',)), batch=8)
        jax_passes = True
    except ValueError as err:
        assert 'HBM budget' in str(err)
        jax_passes = False
    assert jax_passes == (n >= 4)

    # n distinct cards (never touched: CANVAS_HBM_MB is the budget)
    distinct = {torch.device('cuda', i): 1 for i in range(n)}
    try:
        port._check_hbm_footprint(16, box2i(*window), None, 2, CPU,
                                  working_bpp=0, shares=distinct)
        port._check_hbm_footprint(8, box2i(*window), None, None, CPU,
                                  shares=distinct)
        port_passes = True
    except ValueError as err:
        assert 'HBM budget' in str(err)
        port_passes = False
    assert port_passes == jax_passes

    # n entries of one device: every shard lands on it
    green = port_process.SolidColorVideoSource((0, 1, 0, 1))
    repeated = _port_mesh((n,), ('frames',))
    with pytest.raises(ValueError, match='%d of %d frame shards on cpu'
                       % (n, n)):
        port.render_sharded(green, box2i(*window), 0, 16, mesh=repeated,
                            batch=8)
    monkeypatch.setenv('CANVAS_HBM_MB', '64')
    out = port.render_sharded(green, box2i(*window), 0, 16, mesh=repeated,
                              batch=8)
    assert out.shape[0] == 16


def test_batch_must_divide_the_shards():
    planner = port.RenderPlanner(_gray_ramp(port_process, 12),
                                 box2i(*WINDOW), device='cpu')
    with pytest.raises(ValueError, match='not divisible by 4 shards'):
        next(planner.iter_batches(0, 8, batch=6,
                                  mesh=_port_mesh((4,), ('frames',))))
    with pytest.raises(ValueError, match='no axis'):
        next(planner.iter_batches(0, 8, batch=8,
                                  mesh=_port_mesh((4,), ('frames',)),
                                  axis='space'))


# --- the split rule, the plan cache and mesh staging -------------------------

def _editor_cut():
    return timelines.editor_video(timelines.editor_cut(128)[1])


@pytest.mark.parametrize('which', ['headline', 'config7', 'editor_cut'])
def test_split_rule_matches_jax_param_sharding(which):
    """Every param of every op of the plan splits (along the same axis)
    or is replicated exactly as ``canvas_tpu.render._param_sharding``
    decides, never by its shape."""
    from jax.sharding import PartitionSpec
    source = {'headline': lambda: timelines.build_timeline(64),
              'config7': lambda: timelines.mixed_timeline(32),
              'editor_cut': _editor_cut}[which]()
    window = (0, 0, 1919, 1079) if which != 'editor_cut' else (0, 0, 719, 479)
    planner = port.RenderPlanner(source, box2i(*window), device='cpu')
    planner.stage_cache_mb = 0
    jmesh = _jax_mesh((2,), ('frames',))
    seen = set()
    for seg in planner.segments(0, 24)[:2]:
        node = planner._plan(seg)
        for p, op in zip(port.flat_params(node), node.flat_ops([])):
            for k in p:
                ax = port._param_sharding(op, k)
                spec = ref_render._param_sharding(jmesh, 'frames', op,
                                                  k).spec
                if ax is None:
                    assert spec == PartitionSpec(), (op, k, spec)
                else:
                    assert spec == PartitionSpec(*((None,) * ax
                                                   + ('frames',))), (op, k)
                seen.add((op, ax is None))
    assert any(split is False for _op, split in seen)
    assert any(split is True for _op, split in seen)


def test_plan_cache_keys_carry_the_mesh():
    """A sharded and an unsharded pass over one range each plan; a second
    sharded pass plans nothing and uploads nothing."""
    planner = port.RenderPlanner(_two_cuts(port_process), box2i(*WINDOW),
                                 device='cpu')
    plans = []
    real = planner._plan_context

    def counting(seg, mesh=None):
        plans.append((seg, mesh))
        return real(seg, mesh)

    planner._plan_context = counting
    mesh = _port_mesh((4,), ('frames',))

    def run(**kw):
        return np.concatenate([o for _s, _k, o in planner.iter_batches(
            0, 23, batch=8, device_out=False, **kw)])

    first = run(mesh=mesh)
    n_segs = len(plans)
    assert n_segs == len(planner.segments(0, 23, min_span=8)) == 3
    plain = run()
    assert len(plans) == 2 * n_segs
    assert [m for _s, m in plans] == [mesh] * n_segs + [None] * n_segs
    assert len(planner._plan_cache) == 2 * n_segs
    assert sum(1 for k in planner._plan_cache if mesh in k) == n_segs
    again = run(mesh=mesh)
    assert len(plans) == 2 * n_segs
    _same(first, plain)
    _same(again, plain)
    other = run(mesh=_port_mesh((2,), ('frames',)))
    assert len(plans) == 3 * n_segs
    _same(other, plain)


def test_mixed_timeline_staged_onto_the_mesh():
    """Config7's DV planes are staged onto the mesh (``Replicated``
    stacks, their cache keys carrying the mesh) and the sharded render
    equals the unsharded one."""
    window = box2i(0, 0, 959, 539)
    planner = port.RenderPlanner(timelines.mixed_timeline(32), window,
                                 device='cpu')
    mesh = _port_mesh((2,), ('frames',))
    got = np.concatenate([o for _s, _k, o in planner.iter_batches(
        0, 6, batch=4, device_out=False, mesh=mesh)])
    keys = [k for k in planner.persistent_cache._entries
            if k[0] == 'dvplanes']
    assert keys and all(k[3] == mesh for k in keys)
    stacks = [e for k, e in planner.persistent_cache._entries.items()
              if k[0] == 'dvplanes']
    assert all(isinstance(s, Replicated) and list(s.copies) == [CPU]
               for e in stacks for s in e['value']['stacks'])
    want = port.RenderPlanner(timelines.mixed_timeline(32), window,
                              device='cpu').render(0, 6)
    _same(got, want)


# --- write_video(mesh=) ------------------------------------------------------

def _packets(path):
    demux = libav.AVDemuxer(path, 0)
    out = []
    while True:
        pkt = demux.get_next_packet()
        if pkt is None:
            break
        out.append((pkt.data, pkt.pts, pkt.dts, pkt.keyframe))
    demux.close()
    return out


def _cut_at_9(P):
    ws = P.VideoWorkspace()
    ws.add(source=P.SolidColorVideoSource(
        P.LerpFunc((0.0, 0.0, 0.0, 1.0), (1.0, 1.0, 1.0, 1.0), 23)),
        x=0, length=23, z=0)
    ws.add(source=P.SolidColorVideoSource((0.0, 1.0, 0.0, 1.0)),
           x=9, length=7, z=1)
    return ws


@pytest.mark.parametrize('n', SHARDS)
def test_write_video_mesh_matches_unsharded(tmp_path, monkeypatch, n):
    """test_libav.py:246 and :284: write_video(mesh=) across a structure
    cut (ffv1) and at transport='yuv420' (mpeg4), 23 frames that do not
    divide the shards: packets byte-equal to the unsharded export, and
    the decoded frames as the JAX test reads them."""
    if not libav.available():
        pytest.fail('the port builds native/canvas_av.cpp on the CPU')
    monkeypatch.setenv('CANVAS_AV_THREADS', '1')
    mesh = _port_mesh((n,), ('frames',))
    cases = (('ffv1', 'rgba_u8', _cut_at_9(port_process), {}),
             ('mpeg4', 'yuv420', _gray_ramp(port_process, 23),
              {'bit_rate': 2_000_000}))
    for codec, transport, src, kw in cases:
        paths = []
        for m in (mesh, None):
            path = str(tmp_path / ('%s_%s.avi' % (codec, m is not None)))
            libav.write_video(path, src, None, 0, 23, frame_size=(64, 48),
                              frame_rate=25, video_codec=codec, mesh=m,
                              transport=transport, device='cpu', **kw)
            paths.append(path)
        got = _packets(paths[0])
        assert len(got) == 23 and got == _packets(paths[1])
        dec = libav.AVVideoDecoder(paths[0])
        f5 = dec.get_frame_rgba(5, 64, 48)
        f20 = dec.get_frame_rgba(20, 64, 48)
        assert int(f20[24, 32, 0]) > int(f5[24, 32, 0]) + 100
        if codec == 'ffv1':
            f12 = dec.get_frame_rgba(12, 64, 48)
            assert int(f12[24, 32, 1]) > 200 and int(f12[24, 32, 0]) < 60
        dec.close()
