"""The port's public import, ``canvas_tpu_torch.process``, and the public
names of its modules, on the CPU.

- ``process`` re-exports the pull queue (``VideoPullQueue`` and
  ``VideoPullQueueItem`` are ``pullqueue``'s), checked in a fresh
  interpreter under ``tests/test_torch_nojax.py``'s import blocker.
- ``process.time_get_frame`` takes its two branches on the CPU at
  320x180 over the headline and config7: the planner branch under
  ``force_backend('torch', device='cpu')`` and the eager branch
  (``force_eager=True``, and any pull under ``'numpy'``). Each returns
  an int of nanoseconds and pulls frames [lo, hi], the same frames as
  the eager pull (headline: bit-equal; config7: atol 1e-2 with at least
  99% of values bit-equal, the render gates).
- The shims and public names: ``Offscreen``, ``check_context_supported``,
  ``enable_glib_logging``, ``NS_PER_SEC``, ``render.render_frames`` and
  ``render.Node``, ``profiling.timed`` and ``profiling.trace``,
  ``libav.available``, and the backend modes.
- The surface: for every module of ``canvas_tpu`` except
  ``ops/pallas_ops.py``, the port's module of the same name has every
  name of the JAX module's ``__all__`` but the JAX-only ones listed in
  ``JAX_ONLY``.
- Without a card, a default-mode pull of 16,384 pixels or more raises
  (CUDA made absent with monkeypatch, so the test holds on any
  machine), and a 160x90 pull still returns NumPy data.
- A pull queue captures the enqueuing thread's mode: ``'numpy'`` and
  ``('torch', 'cpu')`` pulls of a source without ``plan_cuts`` arrive as
  NumPy and as CPU tensors, and the worker's own mode is restored.
"""

import ast
import importlib
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import canvas_tpu_torch
from canvas_tpu_torch import (backend, ir, libav, process, profiling,
                              pullqueue, render, timelines)
from canvas_tpu_torch.basetypes import box2i
from test_torch_nojax import BLOCKER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

W320 = box2i(0, 0, 319, 179)


def test_process_reexports_the_pull_queue():
    script = BLOCKER + textwrap.dedent('''
        from canvas_tpu_torch import process, pullqueue
        assert process.VideoPullQueue is pullqueue.VideoPullQueue
        assert process.VideoPullQueueItem is pullqueue.VideoPullQueueItem
        assert not ATTEMPTS, ATTEMPTS
        print('REEXPORT_OK')
    ''')
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'REEXPORT_OK' in proc.stdout


# --- time_get_frame ---------------------------------------------------------

def _source(name):
    return (timelines.build_timeline(1024) if name == 'headline'
            else timelines.mixed_timeline(256))


def _close(name, got, want):
    got, want = np.asarray(got, np.float16), np.asarray(want, np.float16)
    if name == 'headline':
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))
        return
    assert float(np.abs(got.astype(np.float32)
                        - want.astype(np.float32)).max()) <= 1e-2
    assert float(np.mean(got.view(np.uint16) == want.view(np.uint16))) >= 0.99


RANGES = {'headline': (128, 135), 'config7': (0, 5)}


@pytest.mark.parametrize('name', sorted(RANGES))
def test_time_get_frame_planner_branch(monkeypatch, name):
    """Under ('torch', 'cpu') a plannable source streams through a
    RenderPlanner on the eager device, its batches fetched to the host:
    the frames equal the eager pull's."""
    lo, hi = RANGES[name]
    src = _source(name)
    seen = []
    built = []
    orig_iter, orig_init = (render.RenderPlanner.iter_batches,
                            render.RenderPlanner.__init__)

    def init(self, *args, **kw):
        orig_init(self, *args, **kw)
        built.append(self.device)

    def iter_batches(self, start, stop, **kw):
        assert kw.get('device_out') is False
        for s, n, out in orig_iter(self, start, stop, **kw):
            seen.append((s, n, np.array(out)))
            yield s, n, out

    monkeypatch.setattr(render.RenderPlanner, '__init__', init)
    monkeypatch.setattr(render.RenderPlanner, 'iter_batches', iter_batches)
    with backend.force_backend('torch', 'cpu'):
        ns = process.time_get_frame(src, lo, hi, W320)
    monkeypatch.undo()
    assert isinstance(ns, int) and ns > 0
    assert built == [torch.device('cpu')]
    frames = {s + k: out[k] for s, n, out in seen for k in range(n)}
    assert sorted(frames) == list(range(lo, hi + 1))
    with backend.force_backend('torch', 'cpu'):
        for f in (lo, hi):
            _close(name, frames[f], src.get_frame_f16(f, W320).to_numpy())


@pytest.mark.parametrize('mode', ['torch-cpu', 'numpy'])
@pytest.mark.parametrize('name', sorted(RANGES))
def test_time_get_frame_eager_branch(name, mode):
    """``force_eager=True`` (or any pull under 'numpy', whose
    ``use_torch_for`` is False) pulls each frame of [lo, hi] eagerly:
    as tensors under ('torch', 'cpu'), as NumPy under 'numpy'; no
    planner is built."""
    lo, hi = RANGES[name]
    src = _source(name)
    pulled = []

    class Recording:
        def plan_cuts(self, start, stop):
            raise AssertionError('the eager branch planned')

        def get_frame_f16(self, frame_index, window):
            frame = src.get_frame_f16(frame_index, window)
            pulled.append((frame_index, frame))
            return frame

    wrapped = Recording()
    m = ('torch', 'cpu') if mode == 'torch-cpu' else ('numpy', None)
    with backend.force_backend(*m):
        ns = process.time_get_frame(wrapped, lo, hi, W320,
                                    force_eager=(mode == 'torch-cpu'))
    assert isinstance(ns, int) and ns > 0
    assert [f for f, _frame in pulled] == list(range(lo, hi + 1))
    kind = torch.Tensor if mode == 'torch-cpu' else np.ndarray
    assert all(isinstance(fr.data, kind) for _f, fr in pulled
               if not fr.current_window.empty())
    with backend.force_backend('numpy'):
        for f, fr in pulled[::3]:
            _close(name, fr.to_numpy(), src.get_frame_f16(f, W320).data)


def test_time_get_frame_default_window_is_dv():
    seen = []

    class Probe:
        def get_frame_f16(self, frame_index, window):
            seen.append(window)
            return process.RgbaFrameF16(window)

    with backend.force_backend('torch', 'cpu'):
        assert process.time_get_frame(Probe(), 0, 1) > 0
    assert seen == [box2i(0, 0, 719, 479)] * 2


# --- shims and public names -------------------------------------------------

def test_offscreen_raises():
    with pytest.raises(NotImplementedError):
        process.Offscreen()
    with pytest.raises(NotImplementedError):
        process.Offscreen(640, 480)


def test_check_context_supported_is_the_card(monkeypatch):
    assert process.check_context_supported() is torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert process.check_context_supported() is False
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert process.check_context_supported() is True


def test_glib_logging_shim_and_ns_per_sec():
    assert process.enable_glib_logging() is None
    assert process.enable_glib_logging(False) is None
    assert canvas_tpu_torch.NS_PER_SEC == process.NS_PER_SEC == 10 ** 9
    assert process.get_frame_time((25, 1), 25) == process.NS_PER_SEC + 1


def test_render_frames_and_node():
    assert render.Node is ir.Node
    src = timelines.build_timeline(64)
    got = render.render_frames(src, W320, 3, 6, device='cpu')
    want = render.RenderPlanner(src, W320, device='cpu').render(3, 6)
    assert got.shape == (3, 4, 180, 320) and got.dtype == np.float16
    np.testing.assert_array_equal(got, want)
    with backend.force_backend('numpy'):
        pull = src.get_frame_f16(4, W320).data
    np.testing.assert_array_equal(got[1], pull)


def test_profiling_timed_and_trace(tmp_path):
    assert profiling.timed is profiling.Timer
    profiling.reset()
    with profiling.timed('test.block'):
        pass
    assert profiling.report()['test.block'][1] == 1
    log_dir = str(tmp_path / 'trace')
    with profiling.trace(log_dir) as where:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert where == log_dir
    path = os.path.join(log_dir, 'trace.json')
    assert os.path.getsize(path) > 0
    with open(path) as fd:
        assert 'traceEvents' in fd.read()


def test_libav_available(monkeypatch):
    assert libav.available() is True          # FFmpeg is present here

    def fail():
        raise RuntimeError('make: no libavcodec/avcodec.h')

    monkeypatch.setattr(libav, '_load', fail)
    assert libav.available() is False


def test_backend_modes():
    assert backend.device_pixel_threshold == 1 << 14
    with pytest.raises(ValueError):
        backend.set_backend('jax')
    with backend.force_backend('numpy'):
        assert not backend.use_torch_for((4, 1080, 1920))
        with backend.force_backend('torch', 'cpu'):
            assert backend.use_torch_for((4, 1, 1))
            assert backend.eager_device() == torch.device('cpu')
        assert backend.get_backend() == 'numpy'
    with backend.force_backend('auto', 'cpu'):
        assert backend.use_torch_for((128, 128))
        assert not backend.use_torch_for((127, 128))


def test_backend_mode_from_environment():
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    got = {}
    for value in ('jax', 'numpy', 'torch'):
        env['CANVAS_TPU_BACKEND'] = value
        got[value] = subprocess.run(
            [sys.executable, '-c', 'from canvas_tpu_torch import backend; '
             'print(backend.get_backend())'], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120).stdout.strip()
    assert got == {'jax': 'torch', 'numpy': 'numpy', 'torch': 'torch'}


# --- the surface ------------------------------------------------------------

#: Names of the JAX package's ``__all__`` lists that have no counterpart
#: in the port: JAX itself and its probes.
JAX_ONLY = frozenset(('jax', 'jnp', 'use_jax_for', 'is_jax_array',
                      'jax_available', 'probe_device'))


def _declares_all(path):
    with open(path) as fd:
        tree = ast.parse(fd.read())
    return any(isinstance(node, ast.Assign)
               and any(getattr(t, 'id', None) == '__all__'
                       for t in node.targets)
               for node in tree.body)


def _jax_modules():
    """The JAX package's modules that declare ``__all__`` (read from
    their source, so collection imports nothing)."""
    root = os.path.join(REPO, 'canvas_tpu')
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ('_native', '__pycache__'))
        rel = os.path.relpath(dirpath, REPO).replace(os.sep, '.')
        for f in sorted(filenames):
            if not f.endswith('.py') or f == '__main__.py':
                continue
            name = rel if f == '__init__.py' else rel + '.' + f[:-3]
            if (name != 'canvas_tpu.ops.pallas_ops'
                    and _declares_all(os.path.join(dirpath, f))):
                out.append(name)
    return out


@pytest.mark.parametrize('name', _jax_modules())
def test_port_module_has_the_jax_modules_names(name):
    names = importlib.import_module(name).__all__
    port = importlib.import_module('canvas_tpu_torch' + name[len('canvas_tpu'):])
    missing = sorted(n for n in names
                     if n not in JAX_ONLY and not hasattr(port, n))
    assert not missing, missing


# --- without a card -----------------------------------------------------------

def test_default_mode_pull_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    src = timelines.build_timeline(64)
    with backend.force_backend('auto'):
        assert backend.use_torch_for((4, 1080, 1920))
        with pytest.raises(RuntimeError, match='CUDA'):
            src.get_frame_f16(5, box2i(0, 0, 1919, 1079))
        with pytest.raises(RuntimeError, match='CUDA'):
            src.get_frame_f16(5, box2i(0, 0, 127, 127))
        small = src.get_frame_f16(5, box2i(0, 0, 159, 89))
        assert isinstance(small.data, np.ndarray)
        with pytest.raises(RuntimeError, match='CUDA'):
            src.get_frame_f16(5, box2i(0, 0, 159, 89), force_gl=True)
        with pytest.raises(RuntimeError, match='CUDA'):
            process.time_get_frame(src, 0, 1, box2i(0, 0, 1919, 1079))
    with backend.force_backend('numpy'):
        frame = src.get_frame_f16(5, box2i(0, 0, 1919, 1079))
    assert isinstance(frame.data, np.ndarray)


# --- the pull queue's capture -------------------------------------------------

class _Eager:
    """A source without plan_cuts: the queue pulls it eagerly."""

    def __init__(self, source):
        self.source = source

    def get_frame_f16(self, frame_index, window):
        return self.source.get_frame_f16(frame_index, window)


def _enqueue_from_thread(queue, source, mode):
    done = threading.Event()
    got = {}

    def deliver(_i, frame, _data):
        got['frame'] = frame
        done.set()

    def enqueue():
        if mode is None:
            queue.enqueue(source, 7, W320, deliver)
        else:
            with backend.force_backend(*mode):
                queue.enqueue(source, 7, W320, deliver)

    t = threading.Thread(target=enqueue)
    t.start()
    t.join()
    assert done.wait(60)
    return got['frame']


def test_pull_queue_captures_the_enqueuing_mode():
    queue = process.VideoPullQueue(workers=1, device='cpu')
    try:
        src = _Eager(timelines.build_timeline(64))
        host = _enqueue_from_thread(queue, src, ('numpy', None))
        cpu = _enqueue_from_thread(queue, src, ('torch', 'cpu'))
        auto = _enqueue_from_thread(queue, src, None)   # 'auto', 57,600 px
        planned = _enqueue_from_thread(queue, timelines.build_timeline(64),
                                       ('numpy', None))
        # the worker thread is back in its own mode
        assert queue._pool.submit(backend.get_backend).result() == \
            backend._DEFAULT
    finally:
        queue.close()
    assert isinstance(host.data, np.ndarray)
    for frame in (cpu, auto):
        assert isinstance(frame.data, torch.Tensor)
        assert frame.data.device.type == 'cpu'
        np.testing.assert_array_equal(frame.to_numpy(), host.data)
    # a plannable source still takes the B=1 planner, whatever the mode
    assert isinstance(planned.data, np.ndarray)
    np.testing.assert_array_equal(planned.data, host.data)
    assert pullqueue.VideoPullQueueItem(src, 0, W320, None, None) \
        .backend_mode == backend._DEFAULT
