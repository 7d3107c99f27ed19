"""A coded image source written in Python (the counterpart of
``scripts/decode_raw_image.py``): DV planes made in Python, reconstructed
by ``DVReconstructionFilter`` and written as a gamma45 u8 PPM.

At 720x480 the pull is above ``backend.device_pixel_threshold``, so in
the default ``'auto'`` mode it takes the torch arms on the card
(``--device cpu``: on the host's cores).

    python -m canvas_tpu_torch.tools.decode_raw_image [OUT.ppm]
        [--device cpu]
"""

import argparse
import sys

import numpy as np

from canvas_tpu_torch import backend, process
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.ops import color as color_ops
from canvas_tpu_torch.tools import add_device_argument, on_device


class FakeDVImageSource(process.CodedImageSource):
    """Gray frame with a black border, built in Python."""

    def get_frame(self, frame, quality=0):
        y = np.full((480, 720), 190, np.uint8)
        y[0, :] = 0
        y[-1, :] = 0
        y[:, 0] = 0
        y[:, -1] = 0
        cb = np.full((480, 180), 0x80, np.uint8)
        cr = np.full((480, 180), 0x80, np.uint8)
        return process.CodedImage([y, cb, cr])


def render_rgb():
    """The reconstructed frame as (480, 720, 3) u8 gamma45 RGB, pulled in
    this thread's backend mode."""
    recon = process.DVReconstructionFilter(FakeDVImageSource())
    frame = recon.get_frame_f16(0, box2i(0, -1, 719, 478))
    u8 = backend.asnumpy(color_ops.apply_gamma45_u8(frame.data))
    return np.ascontiguousarray(np.stack([u8[0], u8[1], u8[2]], axis=-1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('out_path', nargs='?', default='raw_image.ppm')
    add_device_argument(ap)
    args = ap.parse_args(argv)
    with on_device(args.device):
        rgb = render_rgb()
    with open(args.out_path, 'wb') as f:
        f.write(b'P6\n%d %d\n255\n' % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())
    print('wrote', args.out_path, rgb.shape)
    return 0


if __name__ == '__main__':
    sys.exit(main())
