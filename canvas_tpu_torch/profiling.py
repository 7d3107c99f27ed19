"""Per-stage wall timers of the host planner: the counterpart of
``canvas_tpu/profiling.py``'s :class:`Timer` and its report.

``with Timer('render.stage'): ...`` adds the block's wall time to a
named total; :func:`report` reads the totals.
"""

import threading
import time
from collections import defaultdict

__all__ = ['Timer', 'report', 'reset']

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
