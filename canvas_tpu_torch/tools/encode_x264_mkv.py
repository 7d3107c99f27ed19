"""Encode a DV (or any libav-readable) file to H.264 in Matroska (the
counterpart of ``scripts/encode_x264_mkv.py``): native decode -> DV
reconstruction on the card -> libx264 packets -> the Matroska writer.
Needs FFmpeg's development files where the native library is built.

    python -m canvas_tpu_torch.tools.encode_x264_mkv INPUT [OUTPUT.mkv]
        [FRAMES] [--device cpu]
"""

import argparse
import sys

from canvas_tpu_torch.tools import _media, add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('in_path', metavar='INPUT')
    ap.add_argument('out_path', nargs='?', default='test.mkv')
    ap.add_argument('frames', nargs='?', type=int, default=1000)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from canvas_tpu_torch import x264

    with on_device(args.device) as device:
        video, _audio, rate = _media.probe(args.in_path)
        source, width, height = _media.video_source(args.in_path, video)
        params = x264.X264EncoderParams(
            preset='ultrafast', width=width, height=height, frame_rate=rate,
            constant_ratefactor=23.0, interlaced=video.codec == 'dvvideo')
        encoder = x264.X264VideoEncoder(source, 0, args.frames - 1, params,
                                        device=device)
        count = _media.write_mkv(args.out_path,
                                 'canvas_tpu_torch encode_x264_mkv', encoder,
                                 width, height, rate)
    print('wrote %d frames to %s' % (count, args.out_path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
