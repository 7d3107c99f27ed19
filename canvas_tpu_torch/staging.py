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
  thread of ``render``) issues each completed slab's copy on the
  stager's own CUDA stream and goes on filling later rows while it runs.
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
"""

import numpy as np
import torch

from canvas_tpu_torch import backend

__all__ = ['SlabStager', 'SLAB_BYTES']

#: Least bytes per shipped slab (a slab is a multiple of 8 rows).
SLAB_BYTES = int(16e6)


class SlabStager:
    """Stage *n_real* rows of one or more stacks to *device*.

    ``row_specs`` is one ``(row_shape, numpy_dtype)`` per stack. The
    caller fills ``host[k][n]`` for n = 0, 1, ... in order, calls
    ``note_row(n)`` after each row, then ``finish()``, which pads, ships
    the rest and returns the device stacks (one tensor per stack, rows
    ``n_total = n_real`` rounded up to 8). ``consumer`` is the CUDA
    stream that will read the stacks (default: the current stream of
    the thread that calls ``finish``). ``mesh`` is not ported and must
    be None."""

    def __init__(self, row_specs, n_real, device, consumer=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                'staging onto a mesh is not ported to canvas_tpu_torch yet '
                '(ROADMAP.md queue 1 item 8)')
        if n_real < 1:
            raise ValueError('SlabStager needs at least one row')
        self.device = device
        self.n_real = int(n_real)
        self.n_total = self.n_real + ((-self.n_real) % 8)
        cuda = device.type == 'cuda'
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.consumer = consumer
        self._host_t = [
            torch.empty((self.n_total,) + tuple(shape),
                        dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                        pin_memory=cuda)
            for shape, dt in row_specs]
        self.host = tuple(t.numpy() for t in self._host_t)
        if cuda:
            with torch.cuda.stream(self.stream):
                self.stacks = tuple(torch.empty_like(t, device=device)
                                    for t in self._host_t)
        else:
            self.stacks = tuple(torch.empty_like(t) for t in self._host_t)
        row_bytes = sum(t[0].numel() * t.element_size()
                        for t in self._host_t)
        self.slab = 8 * max(1, -(-SLAB_BYTES // max(row_bytes * 8, 1)))
        self.pipelined = self.n_total > self.slab
        self._shipped = 0

    def _ship(self, hi):
        lo, self._shipped = self._shipped, hi
        if self.stream is None:
            for h, d in zip(self._host_t, self.stacks):
                d[lo:hi].copy_(h[lo:hi])
            return
        nbytes = 0
        with torch.cuda.stream(self.stream):
            for h, d in zip(self._host_t, self.stacks):
                d[lo:hi].copy_(h[lo:hi], non_blocking=True)
                nbytes += h[lo:hi].numel() * h.element_size()
        backend.count_h2d(nbytes, len(self.stacks))

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
        if self.stream is not None:
            self.stream.synchronize()
            consumer = (self.consumer if self.consumer is not None
                        else torch.cuda.current_stream(self.device))
            for d in self.stacks:
                d.record_stream(consumer)
        return self.stacks
