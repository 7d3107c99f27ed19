"""Pipelined host-to-device staging of per-frame rows: the counterpart of
``canvas_tpu.render.SlabStager`` (render.py:339-441), rebuilt on pinned
host memory. The port's ``PlanContext.stage`` (host-pulled frames) and
its DV emitter (coded planes) both stage through it.

The policy is the JAX package's: row counts pad to a multiple of 8 by
repeating the last real row (consecutive pipeline chunks then give the
same stack shapes), and rows ship in slabs of at least ~16 MB. What
changed with the device:

- The host stacks are pinned torch tensors, filled by the caller through
  their NumPy views (``stager.host``). A ``non_blocking`` copy from
  pageable memory would be silently synchronous.
- Copies are asynchronous DMA, so no stager thread is needed: the
  thread that plans (the prepare thread of ``iter_batches``, the calling
  thread of ``render``) issues each completed slab's copy on its
  device's copy stream and goes on filling later rows while it runs.
  That stream is made once a device (``_copy_stream``): torch hands out
  its pooled streams round robin, so a new one a stager would sooner or
  later be the stream a render program is capturing on
  (``render._side_stream``), and a stager's copies and wait on it
  invalidate that capture.
- The device stacks are preallocated once and each slab copies into its
  rows, instead of a concatenation of slabs that would transiently
  double device memory (the reason the JAX stager capped pipelining).
- ``finish`` waits on the host for the copy stream, so a plan never
  holds a stack whose rows are still in flight: the render, which reads
  the stacks on its own stream only after the plan is handed over,
  cannot read a row before its copy is done. The stacks were allocated
  on the copy stream, so ``record_stream`` marks them used by the
  render's stream: the caching allocator then does not hand their
  memory to a later stager's copies while the render may still read it.

On ``device='cpu'`` the same code runs with plain (unpinned) tensors and
synchronous copies.

Onto a mesh (``mesh.Mesh``, render.py:339-441's mesh path, which the JAX
package ships in one shot) each slab goes to every distinct device of
the mesh, on that device's own copy stream, from the same pinned host
rows; ``finish`` waits for every stream and returns each stack as a
``mesh.Replicated``, one tensor per device, from which each shard's
upload takes the copy on its own device.
"""

import contextlib
import threading

import numpy as np
import torch

from canvas_tpu_torch import backend
from canvas_tpu_torch.mesh import Mesh, Replicated

__all__ = ['SlabStager', 'SLAB_BYTES', 'device_nbytes']

#: Least bytes per shipped slab (a slab is a multiple of 8 rows).
SLAB_BYTES = int(16e6)

_copy_streams = {}
_copy_streams_lock = threading.Lock()


def _copy_stream(device):
    """The copy stream of *device*, made at its first use and shared by
    every stager after it (each stager waits for its own copies with
    ``finish``)."""
    with _copy_streams_lock:
        stream = _copy_streams.get(device)
        if stream is None:
            stream = _copy_streams[device] = torch.cuda.Stream(device)
        return stream


def device_nbytes(stacks):
    """Device bytes of staged *stacks* (tensors, or ``Replicated`` stacks
    counted once per copy): what a stage-cache entry holding them pins."""
    return sum(s.nbytes if isinstance(s, Replicated)
               else s.numel() * s.element_size() for s in stacks)


def _on(device):
    """``torch.cuda.device(device)`` for a card, nothing for the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class SlabStager:
    """Stage *n_real* rows of one or more stacks to *device*, or with
    *mesh* to every distinct device of the mesh.

    ``row_specs`` is one ``(row_shape, numpy_dtype)`` per stack. The
    caller fills ``host[k][n]`` for n = 0, 1, ... in order, calls
    ``note_row(n)`` after each row, then ``finish()``, which pads, ships
    the rest and returns the device stacks (one tensor per stack, or one
    ``mesh.Replicated`` per stack with *mesh*; rows ``n_total = n_real``
    rounded up to 8). ``consumer`` is the CUDA stream that will read the
    stacks, or with *mesh* a dict of one stream per device (default: the
    current stream of each device for the thread that calls
    ``finish``)."""

    def __init__(self, row_specs, n_real, device, consumer=None, mesh=None):
        if n_real < 1:
            raise ValueError('SlabStager needs at least one row')
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError('mesh must be a canvas_tpu_torch.mesh.Mesh, not '
                            '%r' % (mesh,))
        self.mesh = mesh
        self.devices = (mesh.distinct_devices() if mesh is not None
                        else [device])
        self.device = self.devices[0]
        self.n_real = int(n_real)
        self.n_total = self.n_real + ((-self.n_real) % 8)
        cuda = self.device.type == 'cuda'
        self.streams = ({d: _copy_stream(d) for d in self.devices}
                        if cuda else None)
        self.consumer = consumer
        self._host_t = [
            torch.empty((self.n_total,) + tuple(shape),
                        dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                        pin_memory=cuda)
            for shape, dt in row_specs]
        self.host = tuple(t.numpy() for t in self._host_t)
        self._stacks = {}
        for d in self.devices:
            if cuda:
                with _on(d), torch.cuda.stream(self.streams[d]):
                    self._stacks[d] = tuple(
                        torch.empty_like(t, device=d) for t in self._host_t)
            else:
                self._stacks[d] = tuple(torch.empty_like(t)
                                        for t in self._host_t)
        row_bytes = sum(t[0].numel() * t.element_size()
                        for t in self._host_t)
        self.slab = 8 * max(1, -(-SLAB_BYTES // max(row_bytes * 8, 1)))
        self.pipelined = self.n_total > self.slab
        self._shipped = 0

    def _ship(self, hi):
        lo, self._shipped = self._shipped, hi
        if self.streams is None:
            for d in self.devices:
                for h, t in zip(self._host_t, self._stacks[d]):
                    t[lo:hi].copy_(h[lo:hi])
            return
        nbytes = 0
        for d in self.devices:
            with _on(d), torch.cuda.stream(self.streams[d]):
                for h, t in zip(self._host_t, self._stacks[d]):
                    t[lo:hi].copy_(h[lo:hi], non_blocking=True)
                    nbytes += h[lo:hi].numel() * h.element_size()
        backend.count_h2d(nbytes, len(self._host_t) * len(self.devices))

    def note_row(self, n):
        """Call after host row *n* is filled (0-based, in order)."""
        if self.pipelined and (n + 1) % self.slab == 0:
            self._ship(n + 1)

    def finish(self):
        """Pad the tail rows (repeating the last real row), ship what is
        left, wait for the copies, and return the device stacks."""
        for s in self.host:
            s[self.n_real:] = s[self.n_real - 1]
        if self._shipped < self.n_total:
            self._ship(self.n_total)
        if self.streams is not None:
            for d in self.devices:
                self.streams[d].synchronize()
                if self.mesh is None:
                    consumer = self.consumer
                else:
                    consumer = (self.consumer or {}).get(d)
                if consumer is None:
                    consumer = torch.cuda.current_stream(d)
                for t in self._stacks[d]:
                    t.record_stream(consumer)
        if self.mesh is None:
            return self._stacks[self.device]
        return tuple(Replicated({d: self._stacks[d][k]
                                 for d in self.devices})
                     for k in range(len(self._host_t)))
