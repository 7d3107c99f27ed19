"""The port's replay path on the CPU (``device='cpu'``): the planner's
plan cache, its invalidation, ``iter_batches(max_inflight=...)`` and the
pre-flight memory guard, held to what ``tests/test_render.py`` holds the
JAX package's planner to, and one replay against the JAX package's own.

A replayed pass is compared bit for bit with the first pass of the same
planner (the same prepared params through the same ops). Frames against
the JAX package's replay: a DV clip through a scaler is summed in another
order by XLA, so atol 1e-2 with at least 99% of f16 values bit-equal
(test_torch_mixed.py's limit for rendered frames); solid graphs equal.
"""

import logging

import numpy as np
import pytest

import torch

from canvas_tpu import coded as ref_coded
from canvas_tpu import framefuncs as ref_framefuncs
from canvas_tpu import render as ref_render
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu_torch import backend as port_backend
from canvas_tpu_torch import coded as port_coded
from canvas_tpu_torch import framefuncs as port_framefuncs
from canvas_tpu_torch import plan as port_plan
from canvas_tpu_torch import render as port
from canvas_tpu_torch import sources as port_sources
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.frames import VideoSource
from canvas_tpu_torch.signal import Signal
from canvas_tpu_torch.sources import (SolidColorVideoSource, VideoSequence,
                                      VideoWorkspace)

CPU = torch.device('cpu')

REF = dict(box2i=ref_box2i, coded=ref_coded, framefuncs=ref_framefuncs,
           sources=ref_sources)
PORT = dict(box2i=box2i, coded=port_coded, framefuncs=port_framefuncs,
            sources=port_sources)


def _dv_workspace(lib, pulls=None):
    """A background, a DV clip (seeded planes rolled by the frame) through
    an animated scaler, and a card that starts at frame 8 (a cut)."""
    src, ff = lib['sources'], lib['framefuncs']
    rng = np.random.RandomState(5)
    planes = (rng.randint(16, 236, (480, 720)).astype(np.uint8),
              rng.randint(16, 241, (480, 180)).astype(np.uint8),
              rng.randint(16, 241, (480, 180)).astype(np.uint8))

    class Rolled(lib['coded'].CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            if pulls is not None:
                pulls.append(frame_index)
            return lib['coded'].CodedImage(
                [np.roll(p, frame_index, axis=0) for p in planes])

    clip = src.VideoScaler(
        lib['coded'].DVReconstructionFilter(Rolled()),
        target_point=ff.LerpFunc((10, 5), (40, 30), 24),
        source_point=(0.0, -1.0), scale_factors=(0.25, 0.25),
        source_rect=lib['box2i'](0, -1, 719, 478))
    ws = src.VideoWorkspace()
    ws.add(source=src.SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)), x=0,
           length=24, z=0)
    ws.add(source=clip, x=0, length=24, z=1)
    ws.add(source=src.SolidColorVideoSource(
        (1, 0, 0, 0.5), lib['box2i'](5, 5, 90, 60)), x=8, length=16, z=2)
    return ws


def _two_segments():
    """64 frames with a cut at 32, and the item an edit replaces."""
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.1, 1.0)), x=0, length=64,
           z=0)
    red = ws.add(source=SolidColorVideoSource(
        (1, 0, 0, 0.5), window=box2i(5, 5, 90, 90)), x=32, length=32, z=1)
    return ws, red


def _stream(planner, start, stop, batch, **kw):
    return [(s, n, (o if isinstance(o, np.ndarray) else o.numpy()).copy())
            for s, n, o in planner.iter_batches(start, stop, batch=batch,
                                                **kw)]


class _Counting:
    """Counts ``PlanContext.plan`` calls on *root* while active."""

    def __init__(self, monkeypatch, root):
        self.n = 0
        orig = port_plan.PlanContext.plan

        def plan(ctx, source):
            if source is root:
                self.n += 1
            return orig(ctx, source)

        monkeypatch.setattr(port_plan.PlanContext, 'plan', plan)


class _Custom(VideoSource):
    """A source with no emit (the planner host-stages it) that records
    its pulls and can fire an edit from inside one."""

    def __init__(self, edit_at=None):
        self.pulls = []
        self.edit_at = edit_at
        self.planner = None

    def _render_f16(self, frame_index, frame):
        self.pulls.append(frame_index)
        if frame_index == self.edit_at and self.planner is not None:
            # the edit lands mid-plan and covers this very segment
            self.planner.invalidate_display_cache(0, 7)
        data = np.zeros((4, frame.full_window.height,
                         frame.full_window.width), np.float16)
        data[0] = (frame_index % 5) * 0.2
        data[3] = 1.0
        frame.data = data
        frame.current_window = frame.full_window


# --- replay ---------------------------------------------------------------

def test_second_pass_plans_and_pulls_nothing(monkeypatch):
    pulls = []
    ws = _dv_workspace(PORT, pulls)
    planner = port.RenderPlanner(ws, box2i(0, 0, 319, 179), device='cpu')
    counting = _Counting(monkeypatch, ws)
    first = _stream(planner, 0, 20, 4)
    n_plans, n_pulls = counting.n, len(pulls)
    assert n_plans == 2 and sorted(set(pulls)) == list(range(20))
    assert sorted(k[0] for k in planner._plan_cache) == [(0, 8), (8, 20)]
    assert 'plan cache: 2 prepared segments' in planner.explain(0, 1)
    n_plans, n_pulls = counting.n, len(pulls)      # explain planned (0, 1)
    second = _stream(planner, 0, 20, 4)
    assert counting.n == n_plans and len(pulls) == n_pulls
    assert [(s, n) for s, n, _o in second] == [(s, n) for s, n, _o in first]
    for (_s, _n, a), (_s2, _n2, b) in zip(first, second):
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    # another batch size, post or quality is another plan
    _stream(planner, 0, 8, 2)
    _stream(planner, 0, 8, 4, post='bgra_u8')
    assert counting.n == n_plans + 2
    assert len(planner._plan_cache) == 4


def test_replay_matches_jax():
    """Both packages' second pass over a cached range give the frames of
    their first, and the port's agree with the JAX package's."""
    rp = ref_render.RenderPlanner(_dv_workspace(REF),
                                  ref_box2i(0, 0, 319, 179))
    pp = port.RenderPlanner(_dv_workspace(PORT), box2i(0, 0, 319, 179),
                            device='cpu')
    for _pass in range(2):
        want = [(s, n, np.asarray(o)) for s, n, o in
                rp.iter_batches(0, 12, batch=4)]
        got = _stream(pp, 0, 12, 4)
    assert len(pp._plan_cache) == len(rp._plan_cache) == 2
    assert [(s, n) for s, n, _o in got] == [(s, n) for s, n, _o in want]
    for (_s, _n, a), (_s2, _n2, b) in zip(got, want):
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), rtol=0, atol=1e-2)
        assert np.mean(a.view(np.uint16) == b.view(np.uint16)) >= 0.99


def test_range_invalidation_keeps_untouched_plans():
    window = box2i(0, 0, 159, 119)
    ws, red = _two_segments()
    planner = port.RenderPlanner(ws, window, device='cpu')
    _stream(planner, 0, 64, 8)
    assert sorted(k[0] for k in planner._plan_cache) == [(0, 32), (32, 64)]
    kept = planner._plan_cache[((0, 32), 8, None, 10)][0]

    # the edit touches only [32, 64): the plan of [0, 32) must survive
    red.update(source=SolidColorVideoSource((0, 1, 0, 0.5),
                                            window=box2i(5, 5, 90, 90)))
    planner.invalidate_display_cache(32, 63)
    assert sorted(k[0] for k in planner._plan_cache) == [(0, 32)]
    got = {s: o for s, _n, o in _stream(planner, 0, 64, 8)}
    assert planner._plan_cache[((0, 32), 8, None, 10)][0] is kept
    for i in (0, 40):
        with port_backend.force_backend('numpy'):
            want = np.asarray(ws.get_frame_f16(i, window).data, np.float16)
        np.testing.assert_array_equal(got[(i // 8) * 8][i % 8], want,
                                      err_msg='frame %d' % i)
    # an edit elsewhere keeps both; without a range everything goes
    planner.invalidate_display_cache(500, 600)
    assert len(planner._plan_cache) == 2
    planner.invalidate_display_cache()
    assert not planner._plan_cache


def test_frames_updated_signal_replans(monkeypatch):
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(port_framefuncs.LerpFunc(
        (1, 0, 0, 1), (0, 1, 0, 1), 64)), x=0, length=64, z=0)
    ws.frames_updated = Signal()
    planner = port.RenderPlanner(ws, box2i(0, 0, 31, 15), device='cpu')
    counting = _Counting(monkeypatch, ws)
    _stream(planner, 0, 32, 8)
    n1 = counting.n
    _stream(planner, 0, 32, 8)
    assert counting.n == n1 > 0
    ws.frames_updated.fire(0, 32)
    assert not planner._plan_cache
    _stream(planner, 0, 32, 8)
    assert counting.n > n1
    planner.close()
    assert not planner._plan_cache


def test_invalidation_ignores_bool_args():
    """A trailing positional bool of a frames_updated payload is not the
    range's end (bool is an int subclass)."""
    src = _Custom()
    planner = port.RenderPlanner(src, box2i(0, 0, 15, 15), device='cpu')
    planner.pipeline_chunk = 8
    _stream(planner, 0, 16, 8)
    assert len(planner._plan_cache) == 2
    src.pulls.clear()
    planner.invalidate_display_cache(0, 7, True)
    assert [k[0] for k in planner._plan_cache] == [(8, 16)]
    _stream(planner, 0, 16, 8)
    assert sorted(set(src.pulls)) == list(range(0, 8))  # [8, 16) stayed


def test_invalidation_mid_plan_rejects_stale_inserts():
    """An edit that fires WHILE a segment is planned must not let that
    plan, or its staged stack, enter the caches after the invalidation
    ran: they hold what was there before the edit."""
    src = _Custom(edit_at=3)
    planner = port.RenderPlanner(src, box2i(0, 0, 15, 15), device='cpu')
    planner.pipeline_chunk = 8
    src.planner = planner
    _stream(planner, 0, 16, 8)
    assert sorted(src.pulls) == list(range(16))
    # segment [0, 8) was invalidated mid-plan, [8, 16) was not
    assert [k[0] for k in planner._plan_cache] == [(8, 16)]
    assert len(planner.persistent_cache) == 1
    src.pulls.clear()
    src.planner = None
    _stream(planner, 0, 16, 8)
    assert sorted(set(src.pulls)) == list(range(8))     # re-pulled, re-planned
    assert len(planner._plan_cache) == 2


@pytest.mark.parametrize('off', ['stage_cache_mb', 'plan_cache_segments'])
def test_caches_can_be_switched_off(monkeypatch, off):
    pulls = []
    ws = _dv_workspace(PORT, pulls)
    planner = port.RenderPlanner(ws, box2i(0, 0, 319, 179), device='cpu')
    setattr(planner, off, 0)
    counting = _Counting(monkeypatch, ws)
    first = _stream(planner, 0, 8, 4)
    n_plans, n_pulls = counting.n, len(pulls)
    second = _stream(planner, 0, 8, 4)
    assert not planner._plan_cache
    assert counting.n == 2 * n_plans
    if off == 'stage_cache_mb':
        # no staging budget: the planes are decoded and staged again
        assert len(pulls) == 2 * n_pulls and not len(planner.persistent_cache)
    else:
        assert len(pulls) == n_pulls and len(planner.persistent_cache)
    for (_s, _n, a), (_s2, _n2, b) in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_plan_cache_lru_by_count():
    src = SolidColorVideoSource(port_framefuncs.LerpFunc(
        (1, 0, 0, 1), (0, 1, 0, 1), 64))
    planner = port.RenderPlanner(src, box2i(0, 0, 15, 7), device='cpu')
    planner.pipeline_chunk = planner.max_plan_frames = 4
    planner.plan_cache_segments = 3
    _stream(planner, 0, 20, 4)
    assert [k[0] for k in planner._plan_cache] == [(8, 12), (12, 16),
                                                   (16, 20)]
    _stream(planner, 8, 12, 4)              # a hit moves to the young end
    _stream(planner, 0, 4, 4)
    assert [k[0] for k in planner._plan_cache] == [(16, 20), (8, 12), (0, 4)]


def test_plan_cache_lru_by_pinned_bytes():
    """Plans are also bounded by the device bytes they pin, against the
    staging budget, each storage counted once: a 16-frame segment of a
    host-staged 16x16 source pins one (16, 4, 16, 16) f16 stack of 32 KiB
    however many batches view it."""
    src = _Custom()
    planner = port.RenderPlanner(src, box2i(0, 0, 15, 15), device='cpu')
    planner.pipeline_chunk = planner.max_plan_frames = 16
    planner.stage_cache_mb = 80 / 1024.0            # 80 KiB: two stacks
    _stream(planner, 0, 64, 4)
    stack = 16 * 4 * 16 * 16 * 2
    pinned = [b for _r, b in planner._plan_cache.values()]
    assert all(stack <= b < stack + 4096 for b in pinned), pinned
    assert [k[0] for k in planner._plan_cache] == [(32, 48), (48, 64)]
    prepared = planner._plan_cache[((48, 64), 4, None, 10)][0]
    assert prepared.uploaded == [True] * 4 and len(prepared.spans) == 4
    views = [p['data'] for plist in prepared.plists for p in plist
             if 'data' in p]
    assert len(views) == 4
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1
    # counted before the upload (host leaves at their size) and after
    # (one packed buffer a batch): the stack once either way
    assert stack <= port._pinned_bytes(prepared.plists) < stack + 4096
    # a plan that alone pins more than the budget is not kept at all
    planner.invalidate_display_cache()
    planner.stage_cache_mb = 16 / 1024.0
    del planner._persistent_cache
    _stream(planner, 0, 16, 4)
    assert not planner._plan_cache


def test_set_quality_and_close_clear_plans():
    ws, _red = _two_segments()
    planner = port.RenderPlanner(ws, box2i(0, 0, 63, 47), device='cpu')
    _stream(planner, 0, 40, 8)
    assert len(planner._plan_cache) == 2
    planner.set_quality(10)                     # unchanged: nothing drops
    assert len(planner._plan_cache) == 2
    planner.set_quality(4)
    assert not planner._plan_cache
    _stream(planner, 0, 40, 8)
    assert {k[3] for k in planner._plan_cache} == {4}
    planner.close()
    assert not planner._plan_cache and not len(planner.persistent_cache)


def test_params_to_torch_packs_one_buffer():
    """Every host leaf lands in one buffer, at a multiple of 16 bytes,
    with the dtype, shape and values a copy of its own would give."""
    rng = np.random.default_rng(3)
    staged = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    plists = [[{'color': rng.uniform(0, 1, (5, 4)).astype(np.float32),
                'box': rng.integers(0, 9, (5, 4)).astype(np.int32)},
               {'dy0': np.int64(3), 'dx0': 7},
               {'f64': rng.uniform(0, 1, 3), 'i64': np.arange(5),
                'scalar': np.float32(2.5), 'empty': np.zeros((0, 4),
                                                             np.float32),
                'flag': np.array([True, False]), 'data': staged,
                'strided': np.arange(12, dtype=np.int32)[::2]}],
              [{'rows': np.arange(7, dtype=np.int32)}]]
    for plist in plists:
        have = port.params_to_torch(plist, CPU)
        buffer = have[-1][sorted(k for k, v in have[-1].items()
                                 if isinstance(v, torch.Tensor)
                                 and v is not staged)[0]].untyped_storage()
        assert buffer.nbytes() % 16 == 0
        # the region offsets are leaves like any other: int32 values in
        # the buffer, which the region kernels read on the device
        want = [{k: (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(port._canonical(v))))
                 for k, v in p.items()} for p in plist]
        assert [sorted(p) for p in have] == [sorted(p) for p in want]
        for p, q in zip(have, want):
            for k in q:
                if k in ('dy0', 'dx0'):
                    assert p[k].dtype == torch.int32 and p[k].numel() == 1
                assert p[k].dtype == q[k].dtype and p[k].shape == q[k].shape
                assert p[k].is_contiguous() and torch.equal(p[k], q[k])
                if k != 'data':
                    assert (p[k].untyped_storage().data_ptr()
                            == buffer.data_ptr())
                    assert p[k].data_ptr() % 16 == 0 or not p[k].numel()
    assert port.params_to_torch(plists[0], CPU)[2]['data'] is staged


# --- pacing ---------------------------------------------------------------

@pytest.mark.parametrize('max_inflight', [None, 0, -1, 1, 2])
def test_iter_batches_max_inflight_matches(max_inflight):
    """Pacing leaves the batches as they are, across a segment cut and a
    tail batch, with device tensors and with host arrays."""
    window = box2i(0, 0, 159, 119)
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource(port_framefuncs.LerpFunc(
        (0.2, 0.3, 0.4, 1.0), (0.4, 0.1, 0.2, 1.0), 60)), x=0, length=60,
        z=0)
    ws.add(source=SolidColorVideoSource((1, 0, 0, 0.5),
                                        window=box2i(5, 5, 90, 90)),
           x=20, length=40, z=1)
    planner = port.RenderPlanner(ws, window, device='cpu')
    planner.plan_cache_segments = 0
    want = _stream(planner, 0, 50, 8, device_out=False)
    assert [(s, n) for s, n, _o in want][:4] == [(0, 8), (8, 8), (16, 4),
                                                 (20, 8)]
    for device_out in (True, False):
        got = _stream(planner, 0, 50, 8, max_inflight=max_inflight,
                      device_out=device_out)
        assert [(s, n) for s, n, _o in got] == [(s, n) for s, n, _o in want]
        for (_s, _n, a), (_s2, _n2, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --- the memory guard -----------------------------------------------------

GUARD_WINDOW = (0, 0, 191, 107)          # 192 x 108 = 20736 px
GUARD_PX = 20736


def _guard_planner():
    return port.RenderPlanner(SolidColorVideoSource((0.2, 0.4, 0.6, 1.0)),
                              box2i(*GUARD_WINDOW), device='cpu')


def test_hbm_footprint_guard(monkeypatch, caplog):
    """est = (3 retained * 8 B/px + 16) * batch * px: over the budget
    raises before any launch, 80-100% of it warns, 0 switches it off."""
    est_mb = 40 * 8 * GUARD_PX / (1 << 20)
    planner = _guard_planner()
    launched = []
    monkeypatch.setattr(port, '_get_program',
                        lambda *a, **k: launched.append(1))
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        next(planner.iter_batches(0, 8, batch=8))
    assert not launched and not planner._plan_cache
    monkeypatch.undo()

    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 1.1))
    with caplog.at_level(logging.WARNING, logger='canvas_tpu_torch.render'):
        _s, n, _out = next(planner.iter_batches(0, 8, batch=8))
    assert n == 8 and any('marginal' in r.message for r in caplog.records)

    # bounding max_inflight shrinks the estimate below the same budget
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    _s, n, _out = next(planner.iter_batches(0, 8, batch=8, max_inflight=1))
    assert n == 8
    # a u8 post retains less per pixel but adds its 72 B/px working set:
    # (3 * 4 + 16 + 72) / 40 of the estimate, refused under this budget
    # and let through under one that holds it
    with pytest.raises(ValueError, match="bgra_u8 post's working set"):
        next(planner.iter_batches(0, 8, batch=8, post='bgra_u8'))
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 100 / 40 * 1.1))
    _s, n, _out = next(planner.iter_batches(0, 8, batch=8, post='bgra_u8'))
    assert n == 8

    monkeypatch.setenv('CANVAS_HBM_MB', '0')
    _s, n, _out = next(planner.iter_batches(0, 8, batch=8))
    assert n == 8
    # on the CPU, with nothing set, there is nothing to guard
    monkeypatch.delenv('CANVAS_HBM_MB')
    assert port._hbm_budget_bytes(CPU) is None
    planner.close()


def test_hbm_footprint_guard_one_shot_render(monkeypatch):
    """``render`` keeps one segment's output while it renders it:
    est = (1 * 8 + 16) * n_frames * px."""
    est_mb = 24 * 16 * GUARD_PX / (1 << 20)
    planner = _guard_planner()
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        planner.render(0, 16)
    assert planner.render(0, 8).shape[0] == 8   # half the frames fit
    planner.close()


def test_hbm_footprint_guard_negative_inflight_is_unbounded(monkeypatch):
    est_mb = 40 * 8 * GUARD_PX / (1 << 20)
    planner = _guard_planner()
    monkeypatch.setenv('CANVAS_HBM_MB', str(est_mb * 0.9))
    for depth in (-1, 0):
        with pytest.raises(ValueError, match='HBM budget'):
            next(planner.iter_batches(0, 8, batch=8, max_inflight=depth))
    planner.close()


def test_hbm_footprint_guard_malformed_env(monkeypatch, caplog):
    planner = _guard_planner()
    monkeypatch.setenv('CANVAS_HBM_MB', '80GB')
    with caplog.at_level(logging.WARNING, logger='canvas_tpu_torch.render'):
        _s, n, _out = next(planner.iter_batches(0, 8, batch=8))
    assert n == 8
    assert any('CANVAS_HBM_MB' in r.message for r in caplog.records)
    planner.close()


def test_hbm_footprint_guard_cumulative_render(monkeypatch):
    """``render`` keeps every segment's output until it joins them: the
    whole range counts, two buffers of 8 B/px per frame, though each
    8-frame segment alone fits."""
    src = VideoSequence()
    src.append((SolidColorVideoSource((1, 0, 0, 1)), 0, 8))
    src.append((SolidColorVideoSource((0, 0, 1, 1)), 0, 8))
    total_mb = 16 * 16 * GUARD_PX / (1 << 20)
    planner = port.RenderPlanner(src, box2i(*GUARD_WINDOW), device='cpu')
    assert planner.segments(0, 16) == [(0, 8), (8, 16)]
    monkeypatch.setenv('CANVAS_HBM_MB', str(total_mb * 0.9))
    with pytest.raises(ValueError, match='HBM budget'):
        planner.render(0, 16)
    assert planner.render(0, 7).shape[0] == 7
    planner.close()


#: The working set of ``rgba_u8`` and ``bgra_u8`` at their level gather:
#: the f16 frame (8), the int32 bits (16), the int64 indices (32) and the
#: f32 levels (16).
_GATHER_TERMS = {'f16 frame': 8, 'int32 bits': 16, 'int64 indices': 32,
                 'f32 levels': 16}
_POST_BPP = sum(_GATHER_TERMS.values())
#: ``yuv420``'s fused kernel on a card holds the f16 frame it reads.
_YUV420_TERMS = {'f16 frame': 8}


@pytest.mark.parametrize('post, max_inflight, want_bpp, want_depth', [
    (None, None, 3 * 8 + 16, 3),
    ('rgba_u8', None, 3 * 4 + 16 + _POST_BPP, 3),
    ('bgra_u8', 2, 2 * 4 + 16 + _POST_BPP, 2),
    ('yuv420', 0, 3 * 1.5 + 16 + 8, 3),
    (None, 1, 1 * 8 + 16, 1),
    ('bgra_u8', None, 3 * 4 + 16 + _POST_BPP, 3),
])
def test_hbm_estimate_per_post(post, max_inflight, want_bpp, want_depth):
    """The one model the guard refuses by (and chip_smoke prints): depth
    retained outputs of 8 / 4 / 1.5 B/px by post, a 16 B/px working
    stack and, with a post, its working set term by term, exact in
    bytes: 72 B/px for the u8 interleaves' level gather, the 8 B/px f16
    frame for yuv420's fused kernel."""
    window = box2i(0, 0, 3839, 2159)
    est, depth = port._hbm_estimate_bytes(8, window, post, max_inflight)
    assert depth == want_depth
    assert est == int(want_bpp * 8 * 3840 * 2160)
    assert port._hbm_estimate_bytes(8, window, post, max_inflight,
                                    working_bpp=0)[0] == \
        int((want_bpp - 16) * 8 * 3840 * 2160)
    terms = dict(port.POST_WORKING_BPP.get(post, ()))
    want_terms = {None: {}, 'yuv420': _YUV420_TERMS}.get(post, _GATHER_TERMS)
    assert terms == want_terms


def test_hbm_budget_is_the_cards_total(monkeypatch):
    """Without CANVAS_HBM_MB the budget of a CUDA device is its total
    memory, not the free share."""
    monkeypatch.delenv('CANVAS_HBM_MB', raising=False)
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda device: (3 << 30, 80 << 30))
    assert port._hbm_budget_bytes(torch.device('cuda', 0)) == 80 << 30
    with pytest.raises(ValueError, match='2048 frames at 1920x1080'):
        port._check_hbm_footprint(2048, box2i(0, 0, 1919, 1079), None, None,
                                  torch.device('cuda', 0))
    port._check_hbm_footprint(128, box2i(0, 0, 1919, 1079), None, None,
                              torch.device('cuda', 0))


def test_mesh_still_raises():
    """Only a ``mesh.Mesh`` shards; anything else raises before a plan
    (sharding itself: test_torch_sharded.py)."""
    planner = _guard_planner()
    with pytest.raises(TypeError, match='Mesh'):
        next(planner.iter_batches(0, 4, batch=4, mesh=object()))
