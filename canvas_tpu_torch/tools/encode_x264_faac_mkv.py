"""Encode video (H.264) and audio (AAC) into Matroska (the counterpart
of ``scripts/encode_x264_faac_mkv.py``). Needs FFmpeg's development
files where the native library is built.

    python -m canvas_tpu_torch.tools.encode_x264_faac_mkv INPUT
        [OUTPUT.mkv] [FRAMES] [--device cpu]
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
        video, audio, rate = _media.probe(args.in_path)
        source, width, height = _media.video_source(args.in_path, video)
        params = x264.X264EncoderParams(
            preset='ultrafast', width=width, height=height, frame_rate=rate,
            constant_ratefactor=23.0)
        vencoder = x264.X264VideoEncoder(source, 0, args.frames - 1, params,
                                         device=device)
        aencoder, sample_rate = (
            _media.aac_encoder(args.in_path, args.frames, rate)
            if audio is not None else (None, 48000))
        count = _media.write_mkv(
            args.out_path, 'canvas_tpu_torch encode_x264_faac_mkv', vencoder,
            width, height, rate, aencoder, sample_rate)
    print('wrote %d frames to %s' % (count, args.out_path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
