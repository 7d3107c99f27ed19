"""The port's render programs (``canvas_tpu_torch.render._get_program``:
one CUDA graph per signature on a card) on the CPU, where a program
runs the same binding, body and finish eagerly: everything but the
capture itself.

Held here: one program per (signature, device) across segments, batches
and cold passes, the tail batch its own; the keys of the headline,
config7, each post, the display pull and a shard's device; the program
path against the eager ``run`` and against the JAX package's program
(``canvas_tpu.render._get_program``) on CPU JAX; outputs the caller owns
across later batches; the region offsets as tensors; the launch counts a
replay adds; eviction under the memory guard; ``explain``'s program
line.

Tolerances: the headline and each post bit-equal to the eager run (the
program runs the very same ops); against the JAX package, the headline
bit-equal (as tests/test_torch_render.py measured every case) and each
post within 1 on at most 0.1% of u8 values (tests/test_torch_render.py:
torch's and XLA's ``pow`` may differ in the last ulp next to a u8 step);
config7 within tests/test_torch_mixed.py's gate, atol 1e-2 with at least
99% of f16 values bit-equal (f32 matmuls summed in another order).
"""

import numpy as np
import pytest

import torch

import benchmarks
import bench
from canvas_tpu import render as ref_render
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu_torch import render as port
from canvas_tpu_torch import timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.mesh import Mesh
from canvas_tpu_torch.ops import cuda_ops

CPU = torch.device('cpu')
W320 = (0, 0, 319, 179)
W540 = (0, 0, 959, 539)


@pytest.fixture(autouse=True)
def no_programs():
    """Each test starts with no live program (the cache is the module's,
    shared by every planner in the process) and leaves none."""
    def clear():
        with port._program_lock:
            progs = list(port._program_cache.values())
            port._program_cache.clear()
        port._evict(progs)
    clear()
    yield
    clear()


@pytest.fixture(scope='module')
def headline():
    return timelines.build_timeline(1024)


@pytest.fixture(scope='module')
def ref_headline():
    return bench.build_timeline(1024)


def _stats():
    return port.program_stats()


def _eager(planner, start, stop, batch, post=None):
    """The eager ``run`` of every batch of [start, stop): [(pos, out)]."""
    out = []
    for seg in planner.segments(start, stop, min_span=batch):
        s0, sig, batches = planner._prepare(seg, batch)
        for pos, take, plist in batches:
            got = port.run(sig, port.params_to_torch(plist, CPU), CPU, post)
            out.append((s0 + pos, got[:take]))
    return out


def test_one_program_per_signature_across_passes(headline):
    """Three cold passes (plan cache off) over [0, 20) at batch 8: the
    1-frame segment [0, 1) renders at its own length, its own signature
    and program; [1, 20) in batches of 8, the tail padded to 8, one
    program. Each program's first two calls run eagerly (the second
    captures after it): two captures in all, every later batch a
    replay."""
    planner = port.RenderPlanner(headline, box2i(*W320), device='cpu')
    planner.plan_cache_segments = 0
    before = _stats()
    passes = [[(s, n, out) for s, n, out in planner.iter_batches(
        0, 20, batch=8)] for _rep in range(3)]
    after = _stats()
    assert [(s, n) for s, n, _o in passes[0]] == [(0, 1), (1, 8), (9, 8),
                                                  (17, 3)]
    assert after['captures'] - before['captures'] == 2
    assert after['calls'] - before['calls'] == 3 * 4
    assert after['replays'] - before['replays'] == 3 * 4 - 2 * 2
    assert after['replayed_captures'] - before['replayed_captures'] == 2
    assert after['live'] == 2
    frames = sorted(p['frames'][0] for p in after['programs'])
    assert frames == [1, 8]
    assert sorted(p['calls'] for p in after['programs']) == [3, 9]
    assert sorted(p['replays'] for p in after['programs']) == [1, 7]
    for other in passes[1:]:
        for (s, n, a), (s2, n2, b) in zip(passes[0], other):
            assert (s, n) == (s2, n2) and torch.equal(a, b)
    for (s, n, got), (pos, want) in zip(passes[0], _eager(planner, 0, 20, 8)):
        assert s == pos and torch.equal(got, want)
    planner.close()


def test_one_pass_counts_its_replayed_captures(headline):
    """One cold pass over [0, 20) at batch 8: the 1-frame segment's
    program is called once (eager, never captured); the other program
    runs eagerly, captures and replays once. ``replayed_captures`` counts
    a capture at its first replay only."""
    planner = port.RenderPlanner(headline, box2i(*W320), device='cpu')
    planner.plan_cache_segments = 0
    before = _stats()
    for _out in planner.iter_batches(0, 20, batch=8):
        pass
    mid = _stats()
    assert mid['captures'] - before['captures'] == 1
    assert mid['replays'] - before['replays'] == 1
    assert mid['replayed_captures'] - before['replayed_captures'] == 1
    for _out in planner.iter_batches(1, 20, batch=8):
        pass
    after = _stats()
    assert after['replays'] - mid['replays'] == 3
    assert after['replayed_captures'] == mid['replayed_captures']
    planner.close()


@pytest.mark.parametrize('dy0, dx0', [
    (64, 128),                                           # host ints
    (np.int32(64), np.int32(128)),
    (torch.tensor([64]), torch.tensor([128])),           # int64
    (torch.tensor([64, 0], dtype=torch.int32),
     torch.tensor([128], dtype=torch.int32)),            # two values
])
def test_kernel_offsets_must_be_device_int32(dy0, dx0):
    """A kernel takes its offsets only as int32 tensors of one value on
    its device (checked on the host before their upload); host ints go
    to the plain versions alone."""
    with pytest.raises(ValueError, match='int32'):
        cuda_ops._device_offsets('region_over', dy0, dx0, CPU)
    oy, ox = [torch.tensor([v], dtype=torch.int32) for v in (64, 128)]
    assert cuda_ops._device_offsets('region_over', oy, ox, CPU) == (oy, ox)


def test_program_keys(headline):
    """The JAX package's keys with the device: (signature, device),
    ((signature, 'post', post), device), the display key, and a shard's
    signature on each distinct shard device."""
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    planner.plan_cache_segments = 0
    prepared = planner._prepared((1, 9), 8, None, False)
    sig = prepared.sig
    list(planner.iter_batches(1, 9, batch=8))
    assert (sig, CPU) in port._program_cache
    for post in ('rgba_u8', 'bgra_u8', 'yuv420'):
        list(planner.iter_batches(1, 9, batch=8, post=post))
        assert ((sig, 'post', post), CPU) in port._program_cache
    planner.render_display(3, order=(2, 1, 0), intent=1.25,
                           display_size=(160, 90), transport='rgb24')
    seg = planner._display_seg
    assert ((seg['sig1'], 'display', (2, 1, 0), 1.25, (160, 90), 'rgb24'),
            CPU) in port._program_cache
    mesh = Mesh([CPU, CPU], ('frames',))
    shard = planner._prepared((1, 9), 8, None, False, mesh, 'frames')
    before = _stats()['live']
    list(planner.iter_batches(1, 9, batch=8, mesh=mesh))
    # two shards on one device: one program, called once a shard (the
    # second call captures)
    assert _stats()['live'] == before + 1
    assert (shard.sig, CPU) in port._program_cache
    prog = port._program_cache[(shard.sig, CPU)]
    assert (prog.calls, prog.replays, prog.captured) == (2, 0, True)
    planner.close()


def test_headline_equals_eager_and_jax_program(headline, ref_headline):
    """Frames 1..8 at 320x180: the program path bit-equal to the eager
    ``run`` and to ``canvas_tpu.render._get_program(sig)(params)``."""
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    got = planner.render(1, 9)
    node = planner._plan((1, 9))
    want = port.run(port.signature(node), port.params_to_torch(
        port.flat_params(node), CPU), CPU).numpy()
    np.testing.assert_array_equal(got, want)
    rwin = ref_box2i(*W320)
    ref = ref_render.PlanContext(ref_render.RenderPlanner(ref_headline, rwin),
                                 np.arange(1, 9), rwin).plan(ref_headline)
    assert ref.signature() == port.signature(node)
    jax_out = np.asarray(ref_render._get_program(ref.signature())(
        ref.flat_params([])))
    np.testing.assert_array_equal(got, jax_out)
    planner.close()


@pytest.mark.parametrize('post', ['rgba_u8', 'bgra_u8', 'yuv420'])
def test_posts_equal_eager_and_jax_program(headline, ref_headline, post):
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    planner.plan_cache_segments = 0
    got = [(s, out) for s, _n, out in planner.iter_batches(1, 9, batch=8,
                                                           post=post)]
    assert len(got) == 1
    for (s, a), (pos, b) in zip(got, _eager(planner, 1, 9, 8, post)):
        assert s == pos and a.dtype == torch.uint8 and torch.equal(a, b)
    rwin = ref_box2i(*W320)
    ref = ref_render.PlanContext(ref_render.RenderPlanner(ref_headline, rwin),
                                 np.arange(1, 9), rwin).plan(ref_headline)
    want = np.asarray(ref_render._get_program(ref.signature(), post)(
        ref.flat_params([])))
    diff = np.abs(got[0][1].numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff != 0) <= 1e-3
    planner.close()


def _f16_close(got, want, atol, share):
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=atol)
    equal = np.mean(got.astype(np.float16).view(np.uint16)
                    == want.astype(np.float16).view(np.uint16))
    assert equal >= share, equal


def test_config7_equals_eager_and_jax_program():
    """Frames 0..7 of the mixed timeline at 960x540, batch 4 (DV planes
    staged into the program's slots): bit-equal to the eager run, and
    within tests/test_torch_mixed.py's gate of the JAX package's
    program."""
    mixed = timelines.mixed_timeline(16)
    window = box2i(*W540)
    planner = port.RenderPlanner(mixed, window, device='cpu')
    planner.plan_cache_segments = 0
    got = [(s, n, out) for s, n, out in planner.iter_batches(0, 8, batch=4)]
    eager = _eager(planner, 0, 8, 4)
    assert [(s, n) for s, n, _o in got] == [(s, o.shape[0]) for s, o in eager]
    for (_s, _n, a), (_p, b) in zip(got, eager):
        assert torch.equal(a, b)
    stats = _stats()
    assert any(p['slot_copies'] for p in stats['programs'])
    for seg in planner.segments(0, 8, min_span=4):
        sig = planner._prepared(seg, 4, None, False).sig
        assert (sig, CPU) in port._program_cache      # config7's key
    rwin = ref_box2i(*W540)
    ref_mixed = benchmarks._mixed_timeline(16)
    rplanner = ref_render.RenderPlanner(ref_mixed, rwin)
    rplanner.stage_cache_mb = 0
    want = []
    for s0, s1 in planner.segments(0, 8, min_span=4):
        ref = ref_render.PlanContext(rplanner, np.arange(s0, s1),
                                     rwin).plan(ref_mixed)
        want.append(np.asarray(ref_render._get_program(ref.signature())(
            ref.flat_params([]))))
    mine = np.concatenate([out.numpy() for _s, _n, out in got])
    _f16_close(mine, np.concatenate(want), 1e-2, 0.99)
    planner.close()


def test_render_outputs_stay_valid(headline):
    """``render`` over five segments: one program per signature, each
    replayed after its first call; ``iter_batches``' five batches, all
    held, equal the eager run: no later replay writes into a batch a
    caller holds."""
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    planner.pipeline_chunk = planner.max_plan_frames = 4
    segs = planner.segments(9, 29)
    assert len(segs) == 5
    sigs = [port.signature(planner._plan(seg)) for seg in segs]
    uses = {sig: sigs.count(sig) for sig in sigs}
    before = _stats()
    got = planner.render(9, 29)
    after = _stats()
    assert after['calls'] - before['calls'] == 5
    assert after['captures'] - before['captures'] == sum(
        1 for n in uses.values() if n > 1)
    assert after['replays'] - before['replays'] == sum(
        max(0, n - 2) for n in uses.values())
    want = []
    for seg in segs:
        node = planner._plan(seg)
        want.append(port.run(port.signature(node), port.params_to_torch(
            port.flat_params(node), CPU), CPU).numpy())
    np.testing.assert_array_equal(got, np.concatenate(want))
    held = [out for _s, _n, out in planner.iter_batches(9, 29, batch=4)]
    assert len(held) == 5
    np.testing.assert_array_equal(torch.cat(held).numpy(), got)
    planner.close()


# (H, W, h, w, dy0, dx0): the offsets and overhangs of
# tests/test_torch_ops.py: inside, the bottom, the right, both edges,
# and the mixed timeline's DV regions at 1080p
REGION_CASES = {
    'inside': (256, 512, 128, 256, 64, 128),
    'overhang_bottom': (150, 384, 128, 256, 64, 128),
    'overhang_right': (256, 300, 128, 256, 64, 128),
    'overhang_both': (150, 300, 128, 256, 64, 128),
    'path_704x1152_at_64_512': (1080, 1920, 704, 1152, 64, 512),
    'path_640x1024_at_448_896': (1080, 1920, 640, 1024, 448, 896),
}


@pytest.mark.parametrize('kind', ['region_over', 'region_over_sep'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', sorted(REGION_CASES))
def test_region_plain_takes_tensor_offsets(case, dtype, kind):
    """The plain versions (and the wrappers on the CPU) with the offsets
    as int32 tensors of one value, as the program's buffer holds them,
    equal to the host-int call, in place."""
    H, W, h, w, dy0, dx0 = REGION_CASES[case]
    rng = np.random.default_rng(sorted(REGION_CASES).index(case) + 7)
    P = torch.from_numpy(rng.uniform(0, 1, (1, 3, H, W)).astype(
        np.float32)).to(dtype)
    A = torch.from_numpy(rng.uniform(0, 1, (1, 1, H, W)).astype(
        np.float32)).to(dtype)
    if kind == 'region_over':
        args = (torch.from_numpy(rng.uniform(0, 1, (1, 4, h, w)).astype(
            np.float32)).to(dtype),)
    else:
        args = tuple(torch.from_numpy(rng.uniform(0, 1, s).astype(
            np.float32)) for s in ((1, 4), (1, h), (1, w)))
    offsets = (torch.tensor(dy0, dtype=torch.int32),
               torch.tensor([dx0], dtype=torch.int32))
    want = (P.clone(), A.clone())
    getattr(cuda_ops, kind + '_plain')(*want, *args, dy0, dx0)
    for fn in (getattr(cuda_ops, kind + '_plain'), getattr(cuda_ops, kind)):
        got = (P.clone(), A.clone())
        out = fn(*got, *args, *offsets)
        assert out[0] is got[0] and out[1] is got[1]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(want[1], A)


@pytest.mark.parametrize('h, w, dy0, dx0', [
    (64, 128, 32, 0),         # offset off the block grid
    (64, 128, 0, 64),
    (64, 128, 256, 0),        # region past the (64, 128) envelope
    (64, 128, -64, 0),
])
def test_host_offset_check_refuses(h, w, dy0, dx0):
    """The host-side check refuses what the kernels would read unchecked:
    ``check_offsets``, the plain versions with tensor offsets, and the
    planner's ``check_placed`` on a planned tree."""
    with pytest.raises(ValueError, match='aligned'):
        cuda_ops.check_offsets('placed', dy0, dx0, h, w, 128, 256)
    P, A = torch.zeros((1, 3, 128, 256)), torch.zeros((1, 1, 128, 256))
    with pytest.raises(ValueError, match='aligned'):
        cuda_ops.region_over_plain(P, A, torch.zeros((1, 4, h, w)),
                                   torch.tensor(dy0, dtype=torch.int32),
                                   torch.tensor(dx0, dtype=torch.int32))
    node = port.Node('over_stack', static=(128, 256), children=[
        port.Node('solid_stack'),
        port.Node('placed', static=(h, w),
                  params={'dy0': np.int32(dy0), 'dx0': np.int32(dx0)})])
    with pytest.raises(ValueError, match='aligned'):
        port.check_placed(node)


def test_planned_offsets_are_device_params(headline):
    """A planned segment's region offsets are checked on the host and go
    to the device as int32 leaves of the one packed buffer."""
    planner = port.RenderPlanner(headline, box2i(*W320), device='cpu')
    node = planner._plan((1, 9))
    placed = [c for c in node.children if c.op == 'placed']
    assert placed
    tparams = port.params_to_torch(port.flat_params(node), CPU)
    offsets = [p[k] for p in tparams for k in ('dy0', 'dx0') if k in p]
    assert len(offsets) == 2 * len(placed)
    for t in offsets:
        assert t.dtype == torch.int32 and t.numel() == 1
        assert t.untyped_storage().data_ptr() == tparams.buffer.data_ptr()
    planner.close()


def test_launch_counts_rise_on_replay(headline, monkeypatch):
    """What a program records at its capture is added at every replay,
    and its finish counts as it launches. The CPU runs no kernel, so the
    wrappers are made to count here as a card's launches would."""
    real = {name: getattr(cuda_ops, name)
            for name in ('solid_fold', 'region_over_sep')}

    def counting(name):
        def launch(*args, **kw):
            cuda_ops._count(real[name], False)
            return real[name](*args, **kw)
        return launch

    for name in real:
        monkeypatch.setattr(cuda_ops, name, counting(name))
    planner = port.RenderPlanner(headline, box2i(*W320), device='cpu')
    planner.plan_cache_segments = 0
    counts = []
    for _s, _n, _out in planner.iter_batches(1, 25, batch=8):
        counts.append((real['solid_fold'].launches,
                       real['region_over_sep'].launches))
    steps = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(counts, counts[1:])]
    # per batch what the eager run launches: the body replayed, the
    # finalizing fold in the finish
    _s0, sig, batches = planner._prepare((1, 25), 8)
    before = (real['solid_fold'].launches, real['region_over_sep'].launches)
    port.run(sig, port.params_to_torch(batches[0][2], CPU), CPU)
    eager = (real['solid_fold'].launches - before[0],
             real['region_over_sep'].launches - before[1])
    assert eager[0] == 2 and eager[1] >= 1
    assert steps == [eager, eager], counts
    prog, = [p for p in port._program_cache.values() if p.calls == 3]
    assert dict(prog._launches) == {
        (real['solid_fold'], 'launches'): 1,
        (real['region_over_sep'], 'launches'): eager[1]}
    before = real['solid_fold'].launches
    with cuda_ops.recording() as rec:
        cuda_ops._count(real['solid_fold'], True, False)
    assert real['solid_fold'].launches == before
    assert rec == {(real['solid_fold'], 'launches_bf16'): 1,
                   (real['solid_fold'], 'launches_scalar'): 1}
    planner.close()


def test_eviction_under_the_memory_guard(headline, monkeypatch):
    """The guard counts the bytes live programs hold: a budget that fits
    the batch but not the batch and the programs evicts the least
    recently used; the next batch runs a fresh program, with the same
    frames. A budget below the batch alone still raises before any
    launch."""
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    planner.plan_cache_segments = 0
    first = [out for _s, _n, out in planner.iter_batches(1, 9, batch=8)]
    held = sum(p['held_bytes'] for p in _stats()['programs'])
    assert held > 0
    est = port._hbm_estimate_bytes(8, window, None, None)[0]
    assert port._hbm_estimate_bytes(8, window, None, None,
                                    device=CPU)[0] == est + held
    before = _stats()
    monkeypatch.setenv('CANVAS_HBM_MB', str((est + held / 2) / (1 << 20)))
    again = [out for _s, _n, out in planner.iter_batches(1, 9, batch=8)]
    after = _stats()
    assert after['evictions'] - before['evictions'] == 1
    assert [p['calls'] for p in after['programs']] == [1]
    assert torch.equal(first[0], again[0])
    monkeypatch.setenv('CANVAS_HBM_MB', str(est * 0.9 / (1 << 20)))
    with pytest.raises(ValueError, match='HBM budget'):
        next(planner.iter_batches(1, 9, batch=8))
    planner.close()


def test_explain_reports_the_program(headline):
    planner = port.RenderPlanner(headline, box2i(*W320), device='cpu')
    assert 'segment [1, 9)  8 frames  program not captured' in \
        planner.explain(1, 9)
    planner.render(1, 9)            # the first call runs eagerly
    assert 'program not captured' in planner.explain(1, 9)
    planner.render(1, 9)            # the second captures
    assert 'segment [1, 9)  8 frames  program CAPTURED' in \
        planner.explain(1, 9)
    port._evict([port._program_cache.popitem()[1]])
    assert 'program not captured' in planner.explain(1, 9)
    planner.close()


def test_display_program_equals_eager(headline):
    """``render_display`` through its program: equal to the eager
    ``display_run`` on the same frame, full size and in a viewport; a
    second frame of the segment replays."""
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    for size in (None, (160, 90)):
        got = [planner.render_display(i, display_size=size,
                                      transport='u8') for i in (3, 4)]
        seg = planner._display_seg
        mats = planner._display_matrices(size)
        for i, g in zip((3, 4), got):
            pos = i - seg['lo']
            params = [{k: port._frame_slice(v, port._param_sharding(op, k),
                                            pos)
                       if port._param_sharding(op, k) is not None else v
                       for k, v in p.items()}
                      for p, op in zip(seg['params'], seg['ops'])]
            want = port.display_run(seg['sig1'], params, CPU, mats,
                                    (2, 1, 0, 3), None, 'u8')
            np.testing.assert_array_equal(g, want.numpy().reshape(g.shape))
    progs = [p for p in _stats()['programs'] if 'display' in p['key']]
    assert len(progs) == 2
    assert all((p['calls'], p['replays'], p['captured'])
               == (2, 0, True) for p in progs)
    planner.close()


def test_cuda_index_is_part_of_the_key():
    assert port._program_device('cpu') == CPU
    assert port._program_device(torch.device('cuda', 1)).index == 1


def test_ctypes_signatures_match_the_sources():
    """Each launcher's ctypes argument list has as many entries as its C
    declaration in ``csrc/`` has parameters, pointers where it takes
    pointers (a wrong count only shows on the card, as a TypeError)."""
    import re

    from canvas_tpu_torch.ops import _build
    sources = ''.join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name, argtypes in _build._SIGNATURES.items():
        found = re.search(r'\bint\s+%s\s*\(([^)]*)\)' % name, sources)
        assert found, name
        params = [a.strip() for a in found.group(1).split(',')]
        assert len(params) == len(argtypes), (name, params)
        for param, argtype in zip(params, argtypes):
            assert ('*' in param) == (argtype is _build._P), (name, param)


def test_a_failed_capture_names_the_op():
    """An error inside a program's body carries the innermost op that
    raised it (``canvas_op``), which a failed capture's message names."""
    sig = ('over_stack', (64, 128), (),
           (('solid_stack', (1, 64, 128), (), ()),
            ('no_such_op', (), (), ())))
    solid = {'color': torch.ones((1, 1, 4)),
             'box': torch.tensor([[[0, 63, 0, 127]]], dtype=torch.int32),
             'gain': torch.ones((1, 1)), 'offset': torch.zeros((1, 1))}
    with pytest.raises(ValueError, match='unknown op') as info:
        port._split_eval(sig, iter([{}, solid, {}]), CPU)
    assert info.value.canvas_op == 'no_such_op'
    prog = port._Program(((sig, CPU)), CPU, None)
    assert "failed in op 'no_such_op'" in str(prog._failed(info.value))


def test_guard_at_capture(headline, monkeypatch):
    """A program captures only where its batch's estimate (with the new
    pool on a card) and the live programs fit: it records what the guard
    counted, and what cannot fit raises at the capture, before it."""
    window = box2i(*W320)
    planner = port.RenderPlanner(headline, window, device='cpu')
    prepared = planner._prepared((1, 9), 8, None, False)
    plist = prepared.plists[0]
    prog = port._get_program(prepared.sig, CPU, reserve=12345)
    prog(plist)
    assert not prog.captured and prog.guard_bytes == 0
    prog(plist)
    assert prog.captured
    assert prog.guard_bytes == 12345 + port._held_bytes(CPU)
    post = port._get_program(prepared.sig, CPU, post='yuv420',
                             reserve=2 << 20)
    post(plist)                     # the first call runs eagerly
    monkeypatch.setenv('CANVAS_HBM_MB', '1')
    with pytest.raises(ValueError, match='capturing the render program'):
        post(plist)
    assert not post.captured
    # a card's batch estimate holds one more working stack: the pool
    monkeypatch.delenv('CANVAS_HBM_MB')
    need = port._check_hbm_footprint(8, window, None, None, CPU)
    est = port._hbm_estimate_bytes(8, window, None, None)[0]
    assert need == {CPU: est}
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device: (0, 80 << 30))
    card = torch.device('cuda', 0)
    need = port._check_hbm_footprint(8, window, None, None, card)
    assert need == {card: est + 16 * 8 * window.width * window.height}
    planner.close()


def test_threads_share_programs_under_eviction(headline, monkeypatch):
    """Eight threads render through the one program cache while a tiny
    budget and a cache of two programs evict on every capture (the pull
    queue's workers share programs so): no deadlock, no lost update,
    every frame equal to the eager run."""
    import sys
    import threading

    window = box2i(0, 0, 159, 89)
    planner = port.RenderPlanner(headline, window, device='cpu')
    cases = []
    for seg, batch in (((1, 9), 8), ((1, 5), 4), ((9, 11), 2), ((0, 1), 1)):
        prepared = planner._prepared(seg, batch, None, False)
        plist = prepared.plists[0]
        want = port.run(prepared.sig, port.params_to_torch(plist, CPU), CPU)
        cases.append((prepared.sig, plist, want))
    monkeypatch.setattr(port, '_PROGRAMS_KEPT', 2)
    monkeypatch.setattr(port, '_hbm_budget_bytes', lambda device: 8192)
    errors = []

    def work(k):
        try:
            for i in range(24):
                sig, plist, want = cases[(k + i) % len(cases)]
                got = port._get_program(sig, CPU)(plist)
                if not torch.equal(got, want):
                    errors.append((k, i))
        except Exception as err:       # reported below, with the thread
            errors.append((k, repr(err)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert _stats()['evictions'] > 0
    planner.close()
