"""The port's pull queue (``canvas_tpu_torch.pullqueue.VideoPullQueue``)
and the thumbnails it feeds (``editor.ui.thumbnails.ThumbnailPainter``)
against the JAX package's, on the CPU (``device='cpu'``: the kernels'
plain versions; the JAX queue on CPU JAX, its planner forced with
``force_backend('jax')`` as tests/test_clock_playback.py forces it).

- The cases of tests/test_clock_playback.py's pull queue tests (72-101,
  189-208, 666-790) on both queues: delivery, cancel, custom dispatch,
  a failing source delivering None, join, a closed queue, the planned
  path against the eager pull, the planner LRU.
- Frames: the editor's headline project (``timelines.editor_headline``)
  bit-equal to the JAX queue's; the cut (``timelines.editor_cut``: DV
  clips through scalers) within 4e-3 on all values
  (tests/test_torch_editor_graph.py's tolerance) and within 1 f16 ulp on
  99.98% of them, against the JAX queue and against the JAX package's
  pull path (the JAX queue's B=1 frames are themselves more than 1 ulp
  from that pull on up to 0.012% of a frame's values).
  Thumbnails: u8-equal on the headline; within 1 u8 step on at most
  0.1% of values on the cut.
- What the port does differently on purpose: a planner failure
  delivers None with a warning and is never answered by an eager pull;
  the queue renders on CUDA unless given ``device='cpu'`` and raises
  without a card; an LRU eviction closes a planner only after a pull
  still rendering on it has finished.

Every wait has a deadline (``DEADLINE``).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from canvas_tpu import backend as ref_backend
from canvas_tpu import pullqueue as ref_pullqueue
from canvas_tpu import sources as ref_sources
from canvas_tpu.basetypes import box2i as ref_box2i
from canvas_tpu.editor.ui import thumbnails as ref_thumbnails
from canvas_tpu_torch import pullqueue, render, sources, timelines
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.editor.ui import thumbnails
from test_torch_editor_graph import (W_CUT, W_HEAD, _ref_video, _ulps_f16,
                                     ref_editor_cut, ref_editor_headline)

DEADLINE = 60.0


def _wait(cond, budget=DEADLINE):
    deadline = time.time() + budget
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def _port_queue(**kw):
    return pullqueue.VideoPullQueue(device='cpu', **kw)


def _pull_all(queue, source, frames, window, force_jax=False):
    """{frame index: delivered frame} of *frames* pulled through
    *queue*; the enqueuing thread under force_backend('jax') when
    *force_jax* (the JAX queue captures the caller's mode)."""
    got = {}

    def enqueue():
        for i in frames:
            queue.enqueue(source, i, window,
                          lambda idx, frame, data: got.__setitem__(idx,
                                                                   frame))
    if force_jax:
        with ref_backend.force_backend('jax'):
            enqueue()
    else:
        enqueue()
    assert _wait(lambda: len(got) == len(frames)), sorted(got)
    return got


# --- tests/test_clock_playback.py's pull queue cases, both queues ----------

def test_pull_queue_delivers_with_data():
    for make, src_mod, box in ((_port_queue, sources, box2i),
                               (ref_pullqueue.VideoPullQueue, ref_sources,
                                ref_box2i)):
        queue = make()
        try:
            results = []
            src = src_mod.SolidColorVideoSource((1, 0, 0, 1))
            for i in range(4):
                queue.enqueue(src, i, box(0, 0, 3, 3),
                              lambda idx, frame, data: results.append(
                                  (idx, data, frame)),
                              data=i * 10)
            assert _wait(lambda: len(results) == 4)
            assert sorted(r[0] for r in results) == [0, 1, 2, 3]
            assert sorted(r[1] for r in results) == [0, 10, 20, 30]
            for _i, _d, frame in results:
                np.testing.assert_array_equal(
                    np.asarray(frame.data)[:, 1, 1],
                    np.array([1, 0, 0, 1], np.float16))
        finally:
            queue.close()


def test_pull_queue_cancel_before_pull_delivers_nothing():
    """A pull cancelled before a worker takes it never delivers; the
    workers are held busy so the cancel lands first, in both queues."""
    for make, src_mod, box in ((_port_queue, sources, box2i),
                               (ref_pullqueue.VideoPullQueue, ref_sources,
                                ref_box2i)):
        pending = []
        queue = make(workers=1, dispatch=pending.append)
        gate = threading.Event()

        class Slow:
            def get_frame_f16(self, i, window):
                gate.wait(DEADLINE)
                return None

        try:
            queue.enqueue(Slow(), 0, box(0, 0, 3, 3), lambda *a: None)
            results = []
            item = queue.enqueue(src_mod.SolidColorVideoSource((1, 0, 0, 1)),
                                 1, box(0, 0, 3, 3),
                                 lambda idx, frame, data: results.append(idx))
            item.cancel()
            gate.set()
            queue.join(timeout=DEADLINE)
            for fn in pending:
                fn()
            assert results == []
        finally:
            gate.set()
            queue.close()


def test_custom_dispatch_and_failing_source_deliver_none():
    """Callbacks run through *dispatch*; a source that raises delivers
    frame=None, in both queues (test_clock_playback.py:666)."""
    class BoomSource:
        def get_frame_f16(self, frame_index, window):
            raise RuntimeError('decode exploded')

    for make, box in ((_port_queue, box2i),
                      (ref_pullqueue.VideoPullQueue, ref_box2i)):
        pending = []
        queue = make(dispatch=pending.append)
        try:
            results = []
            queue.enqueue(BoomSource(), 3, box(0, 0, 3, 3),
                          lambda idx, frame, data: results.append(
                              (idx, frame, data)), data='d')
            assert _wait(lambda: pending)
            assert not results
            for fn in pending:
                fn()
            assert results == [(3, None, 'd')]
        finally:
            queue.close()


def test_join_drains_and_closed_queue_refuses():
    for make, src_mod, box in ((_port_queue, sources, box2i),
                               (ref_pullqueue.VideoPullQueue, ref_sources,
                                ref_box2i)):
        queue = make()
        src = src_mod.SolidColorVideoSource((0, 1, 0, 1))
        try:
            results = []
            for i in range(3):
                queue.enqueue(src, i, box(0, 0, 3, 3),
                              lambda idx, frame, data: results.append(idx))
            queue.join(timeout=DEADLINE)
            assert sorted(results) == [0, 1, 2]
            queue.enqueue(src, 9, box(0, 0, 3, 3),
                          lambda idx, frame, data: results.append(idx))
            assert _wait(lambda: 9 in results)
        finally:
            queue.close()
        with pytest.raises(RuntimeError):
            queue.enqueue(src, 0, box(0, 0, 3, 3), lambda *a: None)


def test_planned_path_matches_eager_and_the_jax_queue():
    """test_clock_playback.py:723 on the port: a workspace with a
    sub-rectangle solid pulls through the planner, bit-equal to the
    eager pull and to the JAX queue's planned pull, current windows
    included; a frame past the clip comes back empty."""
    got = {}
    for tag, make, src_mod, box, force in (
            ('port', _port_queue, sources, box2i, False),
            ('ref', ref_pullqueue.VideoPullQueue, ref_sources, ref_box2i,
             True)):
        ws = src_mod.VideoWorkspace()
        ws.add(source=src_mod.SolidColorVideoSource(
            (0.25, 0.5, 0.75, 1.0), window=box(1, 1, 2, 2)), x=0, length=4)
        queue = make()
        try:
            got[tag] = _pull_all(queue, ws, (0, 2, 10), box(0, 0, 3, 3),
                                 force_jax=force)
            assert len(queue._planners) == 1
        finally:
            queue.close()
        for i in (0, 2):
            eager = ws.get_frame_f16(i, box(0, 0, 3, 3))
            assert tuple(got[tag][i].current_window) == \
                tuple(eager.current_window)
            np.testing.assert_array_equal(np.asarray(got[tag][i].data),
                                          np.asarray(eager.data))
        assert got[tag][10].pixel(1, 1) is None
    for i in (0, 2):
        np.testing.assert_array_equal(np.asarray(got['port'][i].data),
                                      np.asarray(got['ref'][i].data))
    ew = got['port'][10].current_window
    assert ew.max.x < ew.min.x or ew.max.y < ew.min.y


def test_planner_lru_eviction_closes_planners(monkeypatch):
    """The planner cache is a bounded LRU; evicted planners close
    (test_clock_playback.py:762)."""
    closes = []
    orig = render.RenderPlanner.close

    def close(self):
        closes.append(self)
        orig(self)

    monkeypatch.setattr(render.RenderPlanner, 'close', close)
    queue = _port_queue(planner_cache=2)
    try:
        for i in range(5):
            src = sources.VideoPassThroughFilter(
                sources.SolidColorVideoSource((i / 8, 0, 0, 1)))
            done = threading.Event()
            queue.enqueue(src, 0, box2i(0, 0, 3, 3),
                          lambda idx, frame, data: done.set())
            assert done.wait(DEADLINE)
        assert len(queue._planners) <= 3
        assert len(closes) >= 2
    finally:
        queue.close()
    assert len(closes) == 5 and not queue._planners


def test_eviction_waits_for_a_running_pull(monkeypatch):
    """A planner evicted while a pull still renders on it closes only
    after that pull: close() never drops the staged stacks and plans a
    render is reading."""
    events = []
    release = threading.Event()
    slow_entered = threading.Event()
    slow = sources.VideoPassThroughFilter(
        sources.SolidColorVideoSource((0.5, 0, 0, 1)))
    orig_render = render.RenderPlanner.render
    orig_close = render.RenderPlanner.close

    def slow_render(self, *a, **kw):
        if self.source is not slow:
            return orig_render(self, *a, **kw)
        slow_entered.set()
        assert release.wait(DEADLINE)
        out = orig_render(self, *a, **kw)
        events.append('slow render done')
        return out

    def close(self):
        if self.source is slow:
            events.append('slow closed')
        orig_close(self)

    monkeypatch.setattr(render.RenderPlanner, 'render', slow_render)
    monkeypatch.setattr(render.RenderPlanner, 'close', close)
    queue = _port_queue(planner_cache=1)
    try:
        got = {}

        def deliver(idx, frame, data):
            got[data] = frame

        queue.enqueue(slow, 0, box2i(0, 0, 3, 3), deliver, data='slow')
        assert slow_entered.wait(DEADLINE)
        for name in ('b', 'c'):
            queue.enqueue(sources.SolidColorVideoSource((0, 1, 0, 1)), 0,
                          box2i(0, 0, 3, 3), deliver, data=name)
            time.sleep(0.2)
        assert events == [] and 'slow' not in got
        release.set()
        assert _wait(lambda: len(got) == 3)
        assert events == ['slow render done', 'slow closed']
        assert all(f is not None for f in got.values())
    finally:
        release.set()
        queue.close()


def test_planner_cache_under_thread_stress(monkeypatch):
    """More workers than cores, a 1 us switch interval, 12 sources over
    a 2-planner LRU: every pull delivers its own source's color (no
    planner serves another source), and every planner the queue built
    is closed exactly once, by eviction or by close()."""
    made, closes = [], {}
    lock = threading.Lock()
    orig_init, orig_close = (render.RenderPlanner.__init__,
                             render.RenderPlanner.close)

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        with lock:
            made.append(self)

    def close(self):
        with lock:
            closes[id(self)] = closes.get(id(self), 0) + 1
        orig_close(self)

    monkeypatch.setattr(render.RenderPlanner, '__init__', init)
    monkeypatch.setattr(render.RenderPlanner, 'close', close)
    workers = (os.cpu_count() or 4) + 2
    srcs = [sources.VideoPassThroughFilter(sources.SolidColorVideoSource(
        (i / 16, 0.5, 0.25, 1))) for i in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    queue = _port_queue(workers=workers, planner_cache=2)
    try:
        got = []
        for rep in range(6):
            for i, src in enumerate(srcs):
                queue.enqueue(src, rep, box2i(0, 0, 3, 3),
                              lambda idx, frame, data: got.append(
                                  (data, frame)), data=i)
        assert _wait(lambda: len(got) == 72, 60), len(got)
    finally:
        queue.close()
        sys.setswitchinterval(old)
    for i, frame in got:
        assert frame is not None
        assert float(np.asarray(frame.data)[0, 1, 1]) == \
            float(np.float16(i / 16)), i
    assert len(made) >= 12
    assert sorted(closes) == sorted(id(p) for p in made)
    assert set(closes.values()) == {1}


def test_planner_failure_delivers_none_never_an_eager_frame(monkeypatch,
                                                            caplog):
    """A failing planner delivers None and logs a warning; the source's
    own NumPy pull is never called (the JAX queue's eager fallback is
    gone)."""
    eager_calls = []

    class Watched(sources.VideoPassThroughFilter):
        def get_frame_f16(self, *a, **kw):
            eager_calls.append(a)
            return super().get_frame_f16(*a, **kw)

    def boom(self, *a, **kw):
        raise RuntimeError('planner exploded')

    monkeypatch.setattr(render.RenderPlanner, 'render', boom)
    src = Watched(sources.SolidColorVideoSource((1, 0, 0, 1)))
    queue = _port_queue()
    try:
        with caplog.at_level('WARNING'):
            got = _pull_all(queue, src, (0, 1), box2i(0, 0, 127, 127))
        assert got == {0: None, 1: None}
        assert eager_calls == []
        assert any('frame pull failed' in r.getMessage()
                   and r.levelname == 'WARNING' for r in caplog.records)
    finally:
        queue.close()


def test_queue_and_thumbnails_default_to_cuda():
    """Built without a device, the queue and a painter without a queue
    render on CUDA, and raise where there is none."""
    if torch.cuda.is_available():
        queue = pullqueue.VideoPullQueue()
        try:
            assert queue.device.type == 'cuda'
        finally:
            queue.close()
        return
    with pytest.raises(RuntimeError, match='CUDA'):
        pullqueue.VideoPullQueue()
    with pytest.raises(RuntimeError, match='CUDA'):
        thumbnails.ThumbnailPainter()


def test_queue_lifecycle_no_thread_leak():
    base = threading.active_count()
    src = sources.SolidColorVideoSource((0.5, 0.5, 0.5, 1.0))
    for _ in range(5):
        q = _port_queue()
        done = threading.Event()
        q.enqueue(src, 0, box2i(0, 0, 15, 15), lambda *a: done.set())
        assert done.wait(DEADLINE)
        q.close()
    assert _wait(lambda: threading.active_count() - base <= 2, 10)


# --- the editor's projects through both queues -----------------------------

@pytest.fixture(scope='module')
def projects():
    """name -> (port video stream, JAX video stream, port window, JAX
    window, frames)."""
    return {
        'headline': (timelines.editor_video(timelines.editor_headline(64)[1]),
                     _ref_video(ref_editor_headline(64)[1]),
                     box2i(*W_HEAD), ref_box2i(*W_HEAD), (0, 21, 40, 63)),
        'cut': (timelines.editor_video(timelines.editor_cut(256)[1]),
                _ref_video(ref_editor_cut(256)[1]),
                box2i(*W_CUT), ref_box2i(*W_CUT), (0, 58, 70, 110)),
    }


@pytest.mark.parametrize('name', ['headline', 'cut'])
def test_project_frames_match_the_jax_queue(projects, name):
    """Headline frames bit-equal, current windows equal. The cut's B=1
    frames within 4e-3 of the JAX queue's on every value
    (tests/test_torch_editor_graph.py's atol for the cut) and, pooled
    over its 4 frames, within 1 f16 ulp on at least 99.98% of values,
    against the JAX queue's frames and against the JAX package's pull
    path: the JAX queue's own B=1 frames are more than 1 ulp from that
    pull on up to 0.012% of a frame's values."""
    port_src, ref_src, win, ref_win, frames = projects[name]
    queue = _port_queue()
    try:
        got = _pull_all(queue, port_src, frames, win)
    finally:
        queue.close()
    ref_queue = ref_pullqueue.VideoPullQueue()
    try:
        want = _pull_all(ref_queue, ref_src, frames, ref_win, force_jax=True)
        assert len(ref_queue._planners) == 1      # the planned path ran
    finally:
        ref_queue.close()
    ulps = {'jax queue': [], 'jax pull': []}
    for i in frames:
        assert tuple(got[i].current_window) == tuple(want[i].current_window)
        g = np.asarray(got[i].data, np.float16)
        w = np.asarray(want[i].data, np.float16)
        assert g.shape == w.shape == (4, win.height, win.width)
        if name == 'headline':
            np.testing.assert_array_equal(g, w)
            continue
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), rtol=0, atol=4e-3)
        pull = np.asarray(ref_src.get_frame_f16(i, ref_win).data, np.float16)
        ulps['jax queue'].append(_ulps_f16(g, w).ravel())
        ulps['jax pull'].append(_ulps_f16(g, pull).ravel())
    for key, parts in ulps.items():
        if parts:
            share = np.mean(np.concatenate(parts) <= 1)
            assert share >= 0.9998, (key, share)


def _thumbs(module, make_queue, src, window, force_jax=False):
    """The 4 thumbnails (32x18) a ThumbnailPainter of *module* makes of
    frames [0, 64) of *src*."""
    queue = make_queue()
    try:
        painter = module.ThumbnailPainter(stream=src, window=window,
                                          size=(32, 18), count=4,
                                          queue=queue)
        painter.set_range(0, 64)
        ready = []
        painter.thumbnail_ready.connect(lambda slot, bgra: ready.append(slot))
        if force_jax:
            with ref_backend.force_backend('jax'):
                painter.request_all()
        else:
            painter.request_all()
        assert _wait(lambda: len(ready) == 4), ready
        return [painter.thumbnail(s) for s in range(4)]
    finally:
        queue.close()


@pytest.mark.parametrize('name', ['headline', 'cut'])
def test_thumbnails_match_the_jax_painter(projects, name):
    """Thumbnails through each package's queue: u8-equal on the
    headline; within 1 step on at most 0.1% of values on the cut."""
    port_src, ref_src, win, ref_win, _frames = projects[name]
    got = _thumbs(thumbnails, _port_queue, port_src, win)
    want = _thumbs(ref_thumbnails, ref_pullqueue.VideoPullQueue, ref_src,
                   ref_win, force_jax=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (18, 32, 4) and g.dtype == np.uint8
        diff = np.abs(g.astype(int) - w.astype(int))
        if name == 'headline':
            np.testing.assert_array_equal(g, w)
        else:
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


def test_thumbnail_epoch_rejects_stale_deliveries():
    """clear() between a pull and its delivery drops the stale
    thumbnail (the epoch token) and a failed pull frees its slot for a
    retry, in both painters."""
    for module, make, src_mod, box in (
            (thumbnails, _port_queue, sources, box2i),
            (ref_thumbnails, ref_pullqueue.VideoPullQueue, ref_sources,
             ref_box2i)):
        pending = []
        queue = make(dispatch=pending.append)
        try:
            painter = module.ThumbnailPainter(
                stream=src_mod.SolidColorVideoSource((1, 0, 0, 1)),
                window=box(0, 0, 31, 31), size=(8, 8), count=2,
                queue=queue)
            painter.request_all()
            assert _wait(lambda: len(pending) == 2)
            painter.set_range(0, 30)          # a new epoch
            for fn in pending:
                fn()
            assert painter.thumbnail(0) is None
            assert painter.thumbnail(1) is None
            pending.clear()
            painter.request_all()
            assert _wait(lambda: len(pending) == 2)
            for fn in pending:
                fn()
            assert painter.thumbnail(0)[4, 4, 2] > 200
            # a None delivery (a failed pull) releases its slot only
            painter.clear()
            pending.clear()
            painter.request_all()
            assert _wait(lambda: len(pending) == 2)
            painter._deliver(0, None, (0, painter._epoch))
            assert 0 not in painter._items and 1 in painter._items
            assert painter.thumbnail(0) is None
        finally:
            queue.close()
