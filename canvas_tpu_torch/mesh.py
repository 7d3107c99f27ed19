"""Device meshes and frames sharded over them: the counterpart of what
``canvas_tpu/render.py`` takes from ``jax.sharding`` (``Mesh``,
``NamedSharding``) and of a sharded ``jax.Array``.

A ``Mesh`` is an ndarray of indexed ``torch.device`` entries with one
name per axis. A device may stand in the mesh more than once, and each
entry is one shard: that is how the port stands in for XLA's virtual
host devices (``--xla_force_host_platform_device_count``), which PyTorch
has no flag for. The CPU tests shard over a mesh of 2, 4 or 8 ``cpu``
entries, and one card runs a logical mesh of ``[cuda:0] * 2``: the whole
sharded path (the split, tail padding, per-shard uploads, replicated
staging, the row reshard and the gather) with no second card. A shard
runs on its entry's device whatever other entries name.

Nothing here concatenates shards onto one device. ``ShardedFrames``
keeps each shard where it was rendered, as a sharded ``jax.Array``
does; ``numpy()`` gathers them into one host array.
"""

import collections

import numpy as np
import torch

__all__ = ['Mesh', 'local_mesh', 'Replicated', 'Sharding', 'ShardedFrames']


def _device(d):
    """*d* as an indexed torch device that exists: 'cuda' names the
    current card, a card that is not there raises, and only CPU and
    CUDA devices are taken."""
    dev = torch.device(d)
    if dev.type == 'cpu':
        return torch.device('cpu')
    if dev.type != 'cuda':
        raise ValueError('unsupported mesh device %r (cpu or cuda)'
                         % (str(dev),))
    if not torch.cuda.is_available():
        raise RuntimeError('mesh device %r requested but CUDA is not '
                           'available' % (str(dev),))
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError('mesh device %r: this machine has %d CUDA '
                           'device(s)' % (str(dev),
                                          torch.cuda.device_count()))
    return torch.device('cuda', index)


class Mesh:
    """An ndarray of devices with named axes (``jax.sharding.Mesh``).

    ``devices`` is anything ``np.asarray`` makes an array of with one
    dimension per name in ``axis_names``: torch devices or their names.
    Each entry becomes an indexed ``torch.device`` (``'cuda'`` the
    current card); a CUDA device that is not there raises. A device may
    appear more than once: each entry is one shard (see the module
    docstring). ``shape`` maps each axis name to its size, as
    ``mesh.shape[axis]`` does in JAX. A mesh is hashable and compares by
    its devices and names: plan and stage-cache keys carry it."""

    def __init__(self, devices, axis_names):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        if len(set(axis_names)) != len(axis_names):
            raise ValueError('mesh axis names repeat: %r' % (axis_names,))
        flat = []

        def walk(x):
            if isinstance(x, (list, tuple, np.ndarray)):
                return [walk(y) for y in x]
            flat.append(_device(x))
            return len(flat) - 1

        index = np.asarray(walk(devices), dtype=np.int64)
        if index.ndim != len(axis_names) or index.size == 0:
            raise ValueError('a mesh of shape %r needs %d axis name(s) and '
                             'a device, got %r' % (index.shape, index.ndim,
                                                   axis_names))
        if len(set(d.type for d in flat)) > 1:
            raise ValueError('a mesh holds CPU or CUDA devices, not both')
        arr = np.empty(index.shape, dtype=object)
        for pos, i in np.ndenumerate(index):
            arr[pos] = flat[i]
        self.devices = arr
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, arr.shape))
        self._key = (arr.shape, axis_names,
                     tuple(str(d) for d in arr.flat))

    @property
    def size(self):
        return self.devices.size

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, Mesh) and other._key == self._key

    def __repr__(self):
        return 'Mesh(%s, devices=[%s])' % (
            ', '.join('%r: %d' % kv for kv in self.shape.items()),
            ', '.join(str(d) for d in self.devices.flat))

    def distinct_devices(self):
        """Each device of the mesh once, in the order of first
        appearance."""
        return list(dict.fromkeys(self.devices.flat))

    def device_at(self, **where):
        """The device at the given index of each named axis (0 on every
        axis not named)."""
        pos = tuple(int(where.get(name, 0)) for name in self.axis_names)
        return self.devices[pos]

    def axis_devices(self, axis):
        """The devices along *axis*, at index 0 of every other axis: the
        device each shard of a split over *axis* renders on."""
        return [self.device_at(**{axis: i})
                for i in range(self.shape[axis])]


def local_mesh(axis='frames'):
    """A one-axis mesh over every visible CUDA device, ``cuda:0`` to
    ``cuda:n-1`` (``render_sharded``'s default, the counterpart of
    ``Mesh(jax.devices(), (axis,))``). Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError('local_mesh() needs CUDA and '
                           'torch.cuda.is_available() is False; pass a '
                           'Mesh of cpu entries to shard on the CPU')
    return Mesh([torch.device('cuda', i)
                 for i in range(torch.cuda.device_count())], (axis,))


class Replicated:
    """One staged array replicated onto each distinct device of a mesh
    (the port's ``NamedSharding(mesh, PartitionSpec())``): one tensor per
    device, the same values in each. A shard takes the copy on its own
    device (``on``)."""

    __slots__ = ('copies',)

    def __init__(self, copies):
        if not copies:
            raise ValueError('Replicated needs at least one copy')
        self.copies = dict(copies)

    @property
    def shape(self):
        return next(iter(self.copies.values())).shape

    @property
    def dtype(self):
        return next(iter(self.copies.values())).dtype

    @property
    def nbytes(self):
        """Device bytes of every copy."""
        return sum(t.numel() * t.element_size()
                   for t in self.copies.values())

    def on(self, device):
        return self.copies[device]

    def __repr__(self):
        return 'Replicated(%s %s on %s)' % (
            tuple(self.shape), self.dtype,
            ', '.join(str(d) for d in self.copies))


class Sharding:
    """How a ``ShardedFrames`` is laid out: the mesh, and for each
    dimension the mesh axis it is split over, or None
    (``NamedSharding(mesh, PartitionSpec(...))``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return 'Sharding(%r, spec=%r)' % (self.mesh, self.spec)


def _bounds(index, shape):
    """A tuple of slices (one per leading dimension named) as
    [(lo, hi)] over every dimension of *shape*."""
    out = []
    for dim, n in enumerate(shape):
        sl = index[dim] if dim < len(index) else slice(None)
        lo, hi, _step = sl.indices(n)
        out.append((lo, max(lo, hi)))
    return tuple(out)


class ShardedFrames:
    """Frames rendered over a mesh: each shard a tensor on its own
    device with the block of the whole it holds (the port's sharded
    ``jax.Array``).

    ``shards`` is a list of ``(tensor, index)``, *index* a tuple of
    slices into the whole array of ``shape`` (a frame range, and under a
    spatial axis a row range). ``dtype`` and ``sharding``
    (``str(sharding)`` names the mesh axes) describe the whole.
    ``numpy()`` (and ``np.asarray``) fetches each shard through pinned
    memory into its block of one host array; frame slicing (``out[:n]``)
    trims shards on their devices."""

    def __init__(self, shards, shape, dtype, sharding):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = [(t, _bounds(index, self.shape))
                       for t, index in shards]
        for t, b in self.shards:
            want = tuple(hi - lo for lo, hi in b)
            if tuple(t.shape) != want:
                raise ValueError('shard of shape %r does not fill its block '
                                 '%r' % (tuple(t.shape), b))

    @property
    def ndim(self):
        return len(self.shape)

    def devices(self):
        """The device of each shard, in order."""
        return [t.device for t, _b in self.shards]

    def __repr__(self):
        return 'ShardedFrames(shape=%r, dtype=%s, %d shards, %r)' % (
            self.shape, self.dtype, len(self.shards), self.sharding)

    def __getitem__(self, key):
        """Frames *key* (a slice with step 1) of the whole, each shard
        cut on its device."""
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError('ShardedFrames takes a frame slice with step 1, '
                            'not %r' % (key,))
        lo, hi, _ = key.indices(self.shape[0])
        hi = max(lo, hi)
        shards = []
        for t, b in self.shards:
            f0, f1 = max(b[0][0], lo), min(b[0][1], hi)
            if f0 >= f1:
                continue
            index = ((slice(f0 - lo, f1 - lo),)
                     + tuple(slice(a, z) for a, z in b[1:]))
            shards.append((t[f0 - b[0][0]:f1 - b[0][0]], index))
        return ShardedFrames(shards, (hi - lo,) + self.shape[1:],
                             self.dtype, self.sharding)

    def to_host(self):
        """The whole array as one CPU tensor: each shard copied into its
        block of one pinned host tensor (pageable off CUDA), after its
        device's work is done."""
        cuda = any(t.device.type == 'cuda' for t, _b in self.shards)
        host = torch.empty(self.shape, dtype=self.dtype, pin_memory=cuda)
        for t, b in self.shards:
            host[tuple(slice(lo, hi) for lo, hi in b)].copy_(t)
        return host

    def numpy(self):
        return self.to_host().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    @staticmethod
    def concatenate(parts):
        """*parts* (each ``ShardedFrames`` of one sharding) one after the
        other along the frame axis; no shard moves or is copied."""
        parts = list(parts)
        if not parts:
            raise ValueError('concatenate needs at least one part')
        first = parts[0]
        shards, at = [], 0
        for p in parts:
            if p.shape[1:] != first.shape[1:] or p.dtype != first.dtype:
                raise ValueError('parts of shapes %r and %r (%s, %s) do not '
                                 'concatenate' % (first.shape, p.shape,
                                                  first.dtype, p.dtype))
            for t, b in p.shards:
                shards.append((t, (slice(b[0][0] + at, b[0][1] + at),)
                               + tuple(slice(lo, hi) for lo, hi in b[1:])))
            at += p.shape[0]
        return ShardedFrames(shards, (at,) + first.shape[1:], first.dtype,
                             first.sharding)

    def reshard(self, mesh, axis, spatial_axis=None):
        """The same values laid out as ``NamedSharding(mesh, P(axis,
        None, spatial_axis, None))``: frame block i (and row block j
        under *spatial_axis*) on the device at index i of *axis* (and j
        of *spatial_axis*). A frame count that does not divide
        ``mesh.shape[axis]`` is padded by repeating the last frame and
        sliced back, as ``canvas_tpu.render.render_sharded`` does: the
        blocks are ceil(frames / shards) long and the last is shorter
        (the padding's frames are never copied). Rows split the same
        way. Each block is assembled on its device from the pieces of
        the shards it overlaps (peer copies between cards)."""
        n = mesh.shape[axis]
        m = mesh.shape[spatial_axis] if spatial_axis is not None else 1
        F = self.shape[0]
        fb = -(-F // n)
        spec = [axis] + [None] * (self.ndim - 1)
        if spatial_axis is not None:
            if self.ndim < 3:
                raise ValueError('a spatial axis splits the rows of '
                                 '(B, C, H, W) frames, not shape %r'
                                 % (self.shape,))
            spec[2] = spatial_axis
        H = self.shape[2] if spatial_axis is not None else 0
        rb = -(-H // m) if spatial_axis is not None else 0
        shards = []
        for i in range(n):
            f0, f1 = min(i * fb, F), min((i + 1) * fb, F)
            for j in range(m):
                where = {axis: i}
                index = [(f0, f1)] + [(0, s) for s in self.shape[1:]]
                if spatial_axis is not None:
                    where[spatial_axis] = j
                    index[2] = (min(j * rb, H), min((j + 1) * rb, H))
                device = mesh.device_at(**where)
                shards.append((self._block(index, device),
                               tuple(slice(lo, hi) for lo, hi in index)))
        return ShardedFrames(shards, self.shape, self.dtype,
                             Sharding(mesh, spec))

    def _block(self, index, device):
        """The whole array's block *index* ([(lo, hi)] per dimension) as
        one tensor on *device*."""
        out = torch.empty(tuple(hi - lo for lo, hi in index),
                          dtype=self.dtype, device=device)
        for t, b in self.shards:
            cut = [(max(lo, blo), min(hi, bhi))
                   for (lo, hi), (blo, bhi) in zip(index, b)]
            if any(lo >= hi for lo, hi in cut):
                continue
            src = t[tuple(slice(lo - blo, hi - blo)
                          for (lo, hi), (blo, _bhi) in zip(cut, b))]
            out[tuple(slice(lo - ilo, hi - ilo)
                      for (lo, hi), (ilo, _ihi) in zip(cut, index))] \
                .copy_(src)
        return out
