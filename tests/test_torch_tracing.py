"""The port's spans and counters (``canvas_tpu_torch.profiling``) on the
CPU: their totals under concurrency, no profiler range and no CUDA event
while no profiler records, where ``iter_batches``' spans land in a trace
(calling thread, prepare thread, segment suffixes and nesting), the
stage- and plan-cache counters over two passes, and the staging spans
inside ``render.plan``; on the card (marked ``gpu``), the post's device
time."""

import json
import os
import re
import sys
import threading
from collections import defaultdict

import numpy as np
import pytest
import torch

from canvas_tpu_torch import backend, coded, framefuncs, profiling
from canvas_tpu_torch import render as port
from canvas_tpu_torch import sources
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.sources import SolidColorVideoSource, VideoWorkspace

WINDOW = box2i(0, 0, 63, 47)
SEGMENT = re.compile(r'^(\S+) \[(\d+), (\d+)\)$')


def _two_segments():
    """64 frames with a cut at 32."""
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.1, 0.1, 1.0)), x=0,
           length=64, z=0)
    ws.add(source=SolidColorVideoSource(
        (1, 0, 0, 0.5), window=box2i(5, 5, 30, 30)), x=32, length=32, z=1)
    return ws


class _Pulled(sources.VideoSource):
    """A source with no emit: the planner host-stages its frames."""

    def _render_f16(self, frame_index, frame):
        data = np.zeros((4, frame.full_window.height,
                         frame.full_window.width), np.float16)
        data[0] = (frame_index % 5) * 0.2
        data[3] = 1.0
        frame.data = data
        frame.current_window = frame.full_window


def _staged():
    """A background under a host-staged source over 32 frames."""
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)), x=0,
           length=32, z=0)
    ws.add(source=_Pulled(), x=0, length=32, z=1)
    return ws


def _dv():
    """A DV clip (seeded planes rolled by the frame) through a scaler over
    a background, 24 frames."""
    rng = np.random.RandomState(5)
    planes = (rng.randint(16, 236, (480, 720)).astype(np.uint8),
              rng.randint(16, 241, (480, 180)).astype(np.uint8),
              rng.randint(16, 241, (480, 180)).astype(np.uint8))

    class Rolled(coded.CodedImageSource):
        def get_frame(self, frame_index, quality=0):
            return coded.CodedImage(
                [np.roll(p, frame_index, axis=0) for p in planes])

    clip = sources.VideoScaler(
        coded.DVReconstructionFilter(Rolled()),
        target_point=framefuncs.LerpFunc((10, 5), (40, 30), 24),
        source_point=(0.0, -1.0), scale_factors=(0.25, 0.25),
        source_rect=box2i(0, -1, 719, 478))
    ws = VideoWorkspace()
    ws.add(source=SolidColorVideoSource((0.1, 0.2, 0.3, 1.0)), x=0,
           length=24, z=0)
    ws.add(source=clip, x=0, length=24, z=1)
    return ws


def _drain(planner, start, stop, batch, fetch=False, **kw):
    for _s, _n, out in planner.iter_batches(start, stop, batch=batch, **kw):
        if fetch:
            backend.to_host(out)


def _counts(names):
    rep = profiling.report()
    return {n: rep.get(n, (0.0, 0, 0.0))[1] for n in names}


def _annotations(log_dir):
    """The trace's ``record_function`` ranges: (name, tid, start, end)."""
    with open(os.path.join(log_dir, 'trace.json')) as fd:
        events = json.load(fd)['traceEvents']
    return [(e['name'], e['tid'], e['ts'], e['ts'] + e['dur'])
            for e in events if e.get('cat') == 'user_annotation']


def _inside(inner, outer):
    """Whether every range named *inner* lies in a range named *outer*
    on its thread."""
    return all(any(o[1] == i[1] and o[2] <= i[2] and i[3] <= o[3]
                   for o in outer) for i in inner)


def test_spans_and_counters_add_up_across_threads():
    profiling.reset()
    n = 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for k in range(n):
                with profiling.Timer('test.span', (k, k + 1)):
                    pass
                profiling.count('test.count', 2)
                profiling.count('test.once')

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rep = profiling.report()
    total, count, mean_ms = rep['test.span']
    assert count == 4 * n and total > 0
    assert mean_ms == pytest.approx(total / count * 1e3)
    assert rep['test.count'] == (0.0, 8 * n, 0.0)
    assert rep['test.once'] == (0.0, 4 * n, 0.0)
    # the segment names the range, not the total
    assert not any(name.startswith('test.span ') for name in rep)
    profiling.reset()
    assert profiling.report() == {}


def test_no_profiler_no_range_and_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('entered while no profiler records')

    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.cuda, 'Event', refuse)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing', refuse)
    profiling.reset()
    with profiling.Timer('test.span', (0, 8)):
        pass
    with profiling.device_span('test.device', torch.device('cuda')):
        pass
    planner = port.RenderPlanner(_two_segments(), WINDOW, device='cpu')
    _drain(planner, 0, 64, 16, fetch=True, post='yuv420')
    rep = profiling.report()
    assert rep['test.span'][1] == 1 and 'test.device' not in rep
    for name in ('render.pass_start', 'render.prepare_wait',
                 'render.dispatch', 'render.bind', 'render.replay',
                 'render.post', 'backend.to_host', 'render.plan',
                 'render.cut'):
        assert rep[name][1] > 0, name
    assert 'render.post.device' not in rep
    # the control: a recording profiler does enter the (refusing) range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match='no profiler records'):
            with profiling.Timer('test.span'):
                pass


def test_trace_shows_the_calling_and_the_prepare_thread(tmp_path):
    planner = port.RenderPlanner(_two_segments(), WINDOW, device='cpu')
    planner.stage_cache_mb = 0
    log_dir = str(tmp_path / 'trace')
    profiling.reset()
    with profiling.trace(log_dir):
        _drain(planner, 0, 64, 16, fetch=True, post='yuv420')
    ranges = _annotations(log_dir)
    named = defaultdict(list)
    segs = defaultdict(set)
    for r in ranges:
        m = SEGMENT.match(r[0])
        base = m.group(1) if m else r[0]
        named[base].append(r)
        if m:
            segs[base].add((int(m.group(2)), int(m.group(3))))
    caller = {r[1] for r in named['render.prepare_wait']}
    assert len(caller) == 1
    for name in ('render.pass_start', 'render.dispatch', 'render.bind',
                 'render.replay', 'render.post', 'backend.to_host'):
        assert named[name] and {r[1] for r in named[name]} == caller, name
    for name in ('render.bind', 'render.replay', 'render.post'):
        assert _inside(named[name], named['render.dispatch']), name
    preparer = {r[1] for r in named['render.plan']}
    assert len(preparer) == 1 and preparer != caller
    assert {r[1] for r in named['render.cut']} == preparer
    # one segment id, shared by the spans of each segment
    assert segs['render.plan'] == {(0, 32), (32, 64)}
    for name in ('render.cut', 'render.prepare_wait', 'render.dispatch'):
        assert segs[name] == segs['render.plan'], name
    # two batches a segment, and each segment's program taken once
    rep = profiling.report()
    assert rep['render.dispatch'][1] == 4 + 2
    assert rep['render.prepare_wait'][1] == 2
    assert rep['render.post'][1] == 4 and rep['backend.to_host'][1] == 4


@pytest.mark.parametrize('keep_plans', [True, False])
def test_second_pass_counts_only_hits(keep_plans):
    planner = port.RenderPlanner(_staged(), WINDOW, device='cpu')
    if not keep_plans:
        planner.plan_cache_segments = 0
    names = ('render.plan_cache.hit', 'render.plan_cache.miss',
             'render.stage_cache.hit', 'render.stage_cache.miss')
    profiling.reset()
    _drain(planner, 0, 32, 8)
    first = _counts(names)
    assert first['render.stage_cache.miss'] > 0
    assert first['render.plan_cache.miss'] == (1 if keep_plans else 0)
    assert first['render.plan_cache.hit'] == 0
    profiling.reset()
    _drain(planner, 0, 32, 8)
    second = _counts(names)
    assert second['render.plan_cache.miss'] == 0
    assert second['render.stage_cache.miss'] == 0
    if keep_plans:
        # nothing planned again, so the stage cache is not asked
        assert second['render.plan_cache.hit'] == 1
        assert second['render.stage_cache.hit'] == 0
    else:
        assert second['render.plan_cache.hit'] == 0
        assert second['render.stage_cache.hit'] > 0
    text = planner.explain(0, 32)
    assert re.search(r'^stage cache: .*; \d+ hits, \d+ misses$', text, re.M)
    assert re.search(r'^plan cache: \d+ prepared segments; %d hits, 0 '
                     r'misses$' % second['render.plan_cache.hit'], text,
                     re.M)


def test_no_plan_cache_lookups_without_a_staging_budget():
    planner = port.RenderPlanner(_staged(), WINDOW, device='cpu')
    planner.stage_cache_mb = 0
    profiling.reset()
    _drain(planner, 0, 32, 8)
    _drain(planner, 0, 32, 8)
    rep = profiling.report()
    assert 'render.plan_cache.hit' not in rep
    assert 'render.plan_cache.miss' not in rep
    # the host-pulled frames staged inside each plan
    assert rep['render.plan'][1] == rep['render.stage'][1] == 2


def test_coded_staging_runs_inside_the_plan(tmp_path):
    planner = port.RenderPlanner(_dv(), box2i(0, 0, 159, 119), device='cpu')
    planner.stage_cache_mb = 0
    log_dir = str(tmp_path / 'trace')
    profiling.reset()
    with profiling.trace(log_dir):
        _drain(planner, 0, 24, 8)
    rep = profiling.report()
    assert rep['render.stage.coded'][1] > 0
    assert rep['render.stage.coded'][0] <= rep['render.plan'][0]
    ranges = _annotations(log_dir)
    stage = [r for r in ranges if r[0] == 'render.stage.coded']
    plans = [r for r in ranges if r[0].startswith('render.plan [')]
    assert stage and _inside(stage, plans)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is False)')
    return torch.device('cuda')


@pytest.mark.gpu
def test_post_device_time_on_card(cuda, tmp_path):
    """Every post outside a capture gets its device time, none inside
    one; the prepare thread shows in the trace."""
    planner = port.RenderPlanner(_two_segments(), WINDOW, device=cuda)
    planner.stage_cache_mb = 0
    _drain(planner, 0, 64, 16, post='yuv420')      # eager runs, captures
    log_dir = str(tmp_path / 'trace')
    profiling.reset()
    with profiling.trace(log_dir):
        _drain(planner, 0, 64, 16, fetch=True, post='yuv420')
        graph = torch.cuda.CUDAGraph()
        x = torch.zeros(16, device=cuda)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            with profiling.device_span('test.captured', cuda):
                x.add_(1)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
    rep = profiling.report()
    total, count, _mean = rep['render.post.device']
    assert count == rep['render.post'][1] == 4 and total > 0
    assert 'test.captured' not in rep
    threads = {r[1] for r in _annotations(log_dir)
               if r[0].startswith('render.plan [')}
    caller = {r[1] for r in _annotations(log_dir)
              if r[0].startswith('render.prepare_wait [')}
    assert threads and caller and not threads & caller
