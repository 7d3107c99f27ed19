"""Device resolution, host-to-device transfer, math mode and CUDA-event
timing for the PyTorch port (the counterpart of
``canvas_tpu/backend.py``).

Device resolution is explicit: the default device is CUDA, and a
missing card raises instead of falling back. Only a caller that asks
for ``device='cpu'`` (the tests) gets the plain PyTorch versions of the
kernels.
"""

import threading

import numpy as np
import torch

__all__ = ['resolve_device', 'is_torch_tensor', 'asnumpy', 'to_device',
           'to_host', 'count_h2d', 'transfer_stats', 'ensure_initialized',
           'cuda_ms', 'paired_ms']


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
    ``non_blocking=True`` and is counted in ``transfer_stats``."""
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
    returned as it is."""
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
