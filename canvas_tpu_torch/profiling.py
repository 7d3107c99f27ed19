"""The port's spans and counters, and a device trace: the counterpart of
``canvas_tpu/profiling.py``.

- ``with Timer('render.plan', seg): ...`` (or :data:`timed`) adds the
  block's host wall time to a named total. While a ``torch.profiler``
  records (:func:`trace`, or the benchmark's traced run), it also opens a
  ``record_function`` range of the span's name, on the profiler's clock
  (the clock of the card's CUPTI events), with *seg*'s frames after the
  name where it is given: ``render.plan [128, 256)``. That suffix is the
  segment id the spans of one segment share; the totals stay keyed by
  the bare name. With no profiler recording, a span enters no range.
- ``count(name, n)`` adds *n* to a named counter.
- ``with device_span(name, device): ...`` adds the device time of the
  work the block enqueues on the current CUDA stream, between two timing
  events, only while a profiler records and never inside a graph
  capture. The time is read once the end event is done (polled at each
  span's exit, waited for by :func:`report`): the hot path never waits.
- :func:`report` reads the totals: ``{name: (total_s, count, mean_ms)}``,
  a counter as ``(0.0, n, 0.0)``.
- ``with trace(log_dir): ...`` records the block with ``torch.profiler``
  on every thread (the CUDA kernels too when a card is present) and
  writes a Chrome trace into *log_dir*, where the JAX package runs
  ``jax.profiler``.

The names, by the thread they run on, and what each nests in:

- the caller, the thread that iterates ``RenderPlanner.iter_batches``:
  ``render.pass_start`` (a pass's entry up to its first plan submitted:
  the memory check, the segments, the new prepare thread);
  ``render.prepare_wait [s0, s1)`` (the wait for a segment's plan);
  ``render.dispatch [s0, s1)`` (a batch: its program taken and called),
  and inside it ``render.bind``, ``render.replay`` and ``render.post``,
  with the device span ``render.post.device`` inside that;
  ``render.inflight_wait`` (the ``max_inflight`` wait). ``render.bind``,
  ``render.replay`` and ``render.post`` fire at every program call
  (``render``, ``render_sharded``, ``render_display`` too).
- the prepare thread (``canvas-torch-plan``): ``render.plan [s0, s1)``
  (a segment's plan, staging included), and inside it
  ``render.stage.coded`` (``coded.device_plane_stack``),
  ``render.stage`` (host-pulled frames) and the counters
  ``render.stage_cache.hit`` / ``.miss`` (``plan.StageLRU.get``, on any
  thread that plans); then ``render.cut [s0, s1)`` (the plan cut into
  batches); the counters ``render.plan_cache.hit`` / ``.miss`` where
  ``iter_batches`` keeps plans.
- any thread: ``backend.to_host`` (a fetch).
- ``libav.write_video``: ``export.render`` (render and fetch) and
  ``export.put_wait`` on its producer thread, ``export.get_wait`` and
  ``export.encode`` on the caller.
"""

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import _ExperimentalConfig

__all__ = ['Timer', 'timed', 'count', 'device_span', 'trace', 'report',
           'reset']

_totals = defaultdict(float)
_counts = defaultdict(int)
# Spans end concurrently on the prepare thread and the calling thread;
# the read-modify-write accumulation needs a lock or same-name spans
# lose counts.
_agg_lock = threading.Lock()

#: Device spans recorded and not yet read, in the order recorded: (name,
#: (card, start event, end event)); spare event triples by card index,
#: at most ``_SPARE_PAIRS`` a card.
_due = deque()
_spare = defaultdict(list)
_SPARE_PAIRS = 64
_events_lock = threading.Lock()


def _recording():
    """Whether a ``torch.profiler`` records now (one flag read)."""
    return _autograd_profiler._is_profiler_enabled


def _add(name, seconds, n):
    with _agg_lock:
        _totals[name] += seconds
        _counts[name] += n


class Timer:
    """A span: ``with Timer('render.plan', (s0, s1)): ...``"""

    def __init__(self, name, seg=None):
        self.name = name
        self.seg = seg
        self._range = None

    def __enter__(self):
        if _recording():
            label = (self.name if self.seg is None
                     else '%s [%d, %d)' % (self.name, *self.seg))
            self._range = _autograd_profiler.record_function(label)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _add(self.name, dt, 1)
        if _due:
            _read_device_spans(wait=False)
        return False


timed = Timer


def count(name, n=1):
    """Add *n* to the counter *name*."""
    _add(name, 0.0, n)


class device_span:
    """Device time of the block's work on the current stream of the
    current CUDA device, added under *name* once it is done: ``with
    device_span('render.post.device', device): ...``, *device* the
    device the block runs on. Nothing off CUDA, with no profiler
    recording or while the stream captures a graph."""

    def __init__(self, name, device):
        self.name = name
        self.device = device
        self._pair = None

    def __enter__(self):
        if not _recording():
            return self
        if (torch.device(self.device).type == 'cuda'
                and not torch.cuda.is_current_stream_capturing()):
            card = torch.cuda.current_device()
            with _events_lock:
                spare = _spare[card]
                pair = spare.pop() if spare else None
            if pair is None:
                pair = (card, torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            pair[1].record()
            self._pair = pair
        return self

    def __exit__(self, *exc):
        pair, self._pair = self._pair, None
        if pair is not None:
            pair[2].record()
            with _events_lock:
                _due.append((self.name, pair))
        return False


def _read_device_spans(wait):
    """Add the device spans whose end event is done (with *wait*, all of
    them, waiting for the card) to the totals."""
    done = []
    with _events_lock:
        while _due and (wait or _due[0][1][2].query()):
            done.append(_due.popleft())
    for name, (_card, start, end) in done:
        end.synchronize()
        _add(name, start.elapsed_time(end) / 1e3, 1)
    with _events_lock:
        for _name, pair in done:
            if len(_spare[pair[0]]) < _SPARE_PAIRS:
                _spare[pair[0]].append(pair)


@contextlib.contextmanager
def trace(log_dir=None):
    """Record the block with ``torch.profiler`` on every thread (the
    prepare thread beside the caller) and write its Chrome trace to
    ``<log_dir>/trace.json`` (*log_dir* None: a new temporary
    directory). Yields *log_dir*."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix='canvas_torch_trace_')
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def report():
    """Aggregated spans and counters: {name: (total_seconds, count,
    mean_ms)}. Waits for the device spans still on the card."""
    if _due:
        _read_device_spans(wait=True)
    with _agg_lock:
        return {name: (total, _counts[name],
                       total / _counts[name] * 1e3 if _counts[name] else 0.0)
                for name, total in _totals.items()}


def reset():
    with _events_lock:
        _due.clear()
    with _agg_lock:
        _totals.clear()
        _counts.clear()
