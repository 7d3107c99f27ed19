"""The eager pull's backend dispatch, device resolution, host-to-device
transfer, math mode and CUDA-event timing for the PyTorch port (the
counterpart of ``canvas_tpu/backend.py``).

Device resolution is explicit: the default device is CUDA, and a
missing card raises instead of falling back. Only a caller that asks
for ``device='cpu'`` (the tests) gets the plain PyTorch versions of the
kernels. ``to_device`` replicates onto a ``mesh.Mesh`` and ``to_host``
gathers a ``mesh.ShardedFrames``.

**The eager pull** (``VideoSource.get_frame_f16/f32``) picks an arm for
each pixel op from a mode held per thread, as the JAX package does:

- ``'auto'`` (the default): frames of ``device_pixel_threshold`` pixels
  or more take the torch arm on :func:`eager_device`, smaller ones the
  NumPy arm. The choice is by frame size alone;
- ``'numpy'``: always the NumPy arm (the planner's host staging pulls
  under it);
- ``'torch'``: always the torch arm.

``set_backend(name, device=None)`` and ``force_backend(name,
device=None)`` also set the thread's eager device: None means CUDA, and
``device='cpu'`` runs the torch arms on the host's cores (the tests).
The default mode comes from ``CANVAS_TPU_BACKEND`` (``auto``, ``numpy``,
``torch``; the JAX package's ``jax`` means ``torch``).

Unlike ``canvas_tpu.backend.use_jax_for``, which answers False when JAX
is missing, :func:`use_torch_for` never looks at whether a card is
present, and no arm falls back to NumPy: a pull that the mode sends to
the torch arm raises the ``RuntimeError`` of ``resolve_device(None)``
when CUDA is missing.
"""

import os
import threading

import numpy as np
import torch

from canvas_tpu_torch import profiling
from canvas_tpu_torch.mesh import Mesh, Replicated, ShardedFrames

__all__ = ['get_backend', 'set_backend', 'force_backend', 'use_torch_for',
           'eager_device', 'torch_device_for', 'device_pixel_threshold',
           'torch_dtype', 'as_tensor', 'constant', 'resolve_device',
           'is_torch_tensor',
           'asnumpy', 'to_device', 'to_host', 'count_h2d', 'transfer_stats',
           'ensure_initialized', 'cuda_ms', 'paired_ms']

#: Pixels per frame at or above which ``'auto'`` takes the torch arm: the
#: JAX package's threshold (a 128x128 tile), kept so that both packages
#: route the same frames.
device_pixel_threshold = 1 << 14

_MODES = ('auto', 'numpy', 'torch')

_state = threading.local()
_DEFAULT = os.environ.get('CANVAS_TPU_BACKEND', 'auto')
if _DEFAULT == 'jax':
    _DEFAULT = 'torch'


def get_backend():
    """This thread's mode: 'auto', 'numpy' or 'torch'."""
    return getattr(_state, 'backend', _DEFAULT)


def _thread_device():
    return getattr(_state, 'device', None)


def set_backend(name, device=None):
    """Set this thread's mode ('auto', 'numpy' or 'torch') and the device
    of its torch arms (None: CUDA)."""
    if name not in _MODES:
        raise ValueError(name)
    _state.backend = name
    _state.device = device


class force_backend:
    """Context manager that pins this thread's mode and eager device and
    restores both on exit (used heavily in tests)."""

    def __init__(self, name, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        self.saved = (get_backend(), _thread_device())
        set_backend(self.name, self.device)
        return self

    def __exit__(self, *exc):
        set_backend(*self.saved)
        return False


def use_torch_for(shape):
    """Whether an eager op over an array of this shape takes the torch
    arm under this thread's mode (the counterpart of ``use_jax_for``)."""
    mode = get_backend()
    if mode == 'numpy':
        return False
    if mode == 'torch':
        return True
    pixels = 1
    for dim in shape[-2:]:
        pixels *= int(dim)
    return pixels >= device_pixel_threshold


def eager_device():
    """The device of this thread's torch arms: ``resolve_device`` of the
    device its mode was set with (None: CUDA, raising without it)."""
    return resolve_device(_thread_device())


def torch_device_for(shape, *arrays):
    """Device of the torch arm for an eager op over *arrays* whose frame
    has *shape*, or None for the NumPy arm. A tensor among *arrays*
    decides (its device); otherwise ``use_torch_for(shape)`` does
    (:func:`eager_device`)."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    if use_torch_for(shape):
        return eager_device()
    return None


_TORCH_DTYPES = {np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


def torch_dtype(dtype):
    """The torch dtype of a frame's NumPy dtype (f16 or f32)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def as_tensor(x, device):
    """*x* (a tensor, a NumPy array or a scalar sequence) as a tensor on
    *device*. A NumPy array is copied, never aliased; to a CUDA device
    through pinned memory without waiting (a pageable copy would wait
    for every kernel queued before it)."""
    if isinstance(x, torch.Tensor):
        t = x.to(device)
    else:
        t = torch.from_numpy(np.array(x, order='C', copy=True))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
    return t


_constants = {}
_constants_lock = threading.Lock()


def constant(array, device):
    """A module-level NumPy constant (a matrix, a table) on *device*,
    uploaded once per (array, device)."""
    key = (id(array), str(device))
    with _constants_lock:
        got = _constants.get(key)
        if got is None or got[0] is not array:
            got = _constants[key] = (array, as_tensor(array, device))
    return got[1]


def resolve_device(device=None):
    """``torch.device`` to render on. None means CUDA, and raises when
    CUDA is missing; pass ``device='cpu'`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'canvas_tpu_torch renders on a CUDA device and '
                'torch.cuda.is_available() is False; pass device="cpu" '
                'to run the plain PyTorch versions of the kernels')
        return torch.device('cuda')
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device %r requested but CUDA is not available'
                           % (str(dev),))
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device %r (cpu or cuda)' % (str(dev),))
    return dev


def is_torch_tensor(x):
    return isinstance(x, torch.Tensor)


def asnumpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: Cumulative host->device bytes and copies made by ``to_device`` onto a
#: CUDA device (counterpart of canvas_tpu.backend.transfer_stats).
transfer_stats = {'h2d_bytes': 0, 'h2d_calls': 0}
_stats_lock = threading.Lock()


def to_device(host_array, device):
    """Copy a numpy array (0-d included) to *device* as a tensor that
    owns its memory. On CUDA the copy goes from pinned memory with
    ``non_blocking=True`` and is counted in ``transfer_stats``.

    *device* may be a ``mesh.Mesh`` (the mesh arm of the JAX package's
    ``stage_to_device``, backend.py:282-296): the array is copied once
    to each distinct device of the mesh, each copy counted, and comes
    back as a ``mesh.Replicated``, one tensor per device."""
    if isinstance(device, Mesh):
        return Replicated({d: to_device(host_array, d)
                           for d in device.distinct_devices()})
    t = torch.from_numpy(np.array(host_array, order='C', copy=True))
    if device.type != 'cuda':
        return t
    out = t.pin_memory().to(device, non_blocking=True)
    with _stats_lock:
        transfer_stats['h2d_bytes'] += t.numel() * t.element_size()
        transfer_stats['h2d_calls'] += 1
    return out


def to_host(t):
    """A CPU copy of tensor *t*: a CUDA tensor goes through pinned memory
    (PyTorch's caching host allocator), one copy at the link's rate,
    where ``.cpu()`` into pageable memory moves the bytes through a
    staging buffer. The copy waits for the device; a CPU tensor is
    returned as it is. A ``mesh.ShardedFrames`` comes back whole, each
    shard copied into its block of one host tensor. A span,
    ``backend.to_host``."""
    with profiling.Timer('backend.to_host'):
        if isinstance(t, ShardedFrames):
            return t.to_host()
        if t.device.type != 'cuda':
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)


def count_h2d(nbytes, calls):
    """Add host->device copies made elsewhere (the staging slabs) to
    ``transfer_stats``."""
    with _stats_lock:
        transfer_stats['h2d_bytes'] += int(nbytes)
        transfer_stats['h2d_calls'] += int(calls)


def ensure_initialized():
    """Pin the quality-10 math mode: full f32 in matrix products and
    convolutions (no TF32), the counterpart of JAX's
    ``precision='highest'``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def cuda_ms(fn, reps):
    """Mean device milliseconds of *fn* over *reps* back-to-back runs,
    after one warm-up run (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def paired_ms(kernel, plain, reps, plain_reps):
    """(kernel ms, plain ms), each the mean of two timings taken in the
    order plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2
