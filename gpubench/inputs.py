"""Inputs drawn from ``--seed``, handed alike to the program and to the
reference: the coded planes of the DV clips and the frames the check
samples. NumPy only."""

import numpy as np

#: DV 4:1:1 plane shapes (Y, Cb, Cr) of a 720x480 frame.
DV_SHAPES = ((480, 720), (480, 180), (480, 180))


def rng(seed, stream):
    """The generator of *stream* (a small int) for *seed*: every use of
    the seed draws from its own stream, so one draw never moves another."""
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def dv_base_planes(seed, clip):
    """Clip *clip*'s seeded u8 planes: Y in the studio range 16..235, Cb
    and Cr in 16..240."""
    g = rng(seed, 16 + int(clip))
    y = g.integers(16, 236, DV_SHAPES[0], dtype=np.uint8)
    cb = g.integers(16, 241, DV_SHAPES[1], dtype=np.uint8)
    cr = g.integers(16, 241, DV_SHAPES[2], dtype=np.uint8)
    return y, cb, cr


def dv_frame_planes(base, frame_index):
    """The planes of frame *frame_index*: the base planes rolled down by
    the frame index, so every frame's planes differ from its
    neighbours'."""
    return tuple(np.roll(p, int(frame_index), axis=0) for p in base)


class Reservoir:
    """A uniform sample of *k* items of a stream of unknown length
    (Algorithm R), drawn from the seed: the frames the check compares."""

    def __init__(self, seed, k):
        self.k = int(k)
        self.seen = 0
        self.items = []
        self._rng = rng(seed, 2)

    def slot(self):
        """The slot the next item takes, or None: call once per item."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self._rng.integers(self.seen))
        return j if j < self.k else None
