"""Per-stage wall timers of the host planner and a device trace: the
counterpart of ``canvas_tpu/profiling.py``.

``with Timer('render.stage'): ...`` (or :data:`timed`) adds the block's
wall time to a named total; :func:`report` reads the totals.
``with trace(log_dir): ...`` records the block with ``torch.profiler``
(the CUDA kernels too when a card is present) and writes a Chrome trace
into *log_dir*, where the JAX package runs ``jax.profiler``.
"""

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict

__all__ = ['Timer', 'timed', 'trace', 'report', 'reset']

_totals = defaultdict(float)
_counts = defaultdict(int)
# Timers run concurrently on the prepare thread and the calling thread;
# the read-modify-write accumulation needs a lock or same-name timers
# lose counts.
_agg_lock = threading.Lock()


class Timer:
    """Accumulating wall timer: ``with Timer('stage'): ...``"""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        with _agg_lock:
            _totals[self.name] += dt
            _counts[self.name] += 1
        return False


timed = Timer


@contextlib.contextmanager
def trace(log_dir=None):
    """Record the block with ``torch.profiler`` and write its Chrome trace
    to ``<log_dir>/trace.json`` (*log_dir* None: a new temporary
    directory). Yields *log_dir*."""
    import torch

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix='canvas_torch_trace_')
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def report():
    """Aggregated timings: {name: (total_seconds, count, mean_ms)}."""
    with _agg_lock:
        return {name: (total, _counts[name],
                       total / _counts[name] * 1e3 if _counts[name] else 0.0)
                for name, total in _totals.items()}


def reset():
    with _agg_lock:
        _totals.clear()
        _counts.clear()
