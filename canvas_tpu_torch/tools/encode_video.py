"""Transcode a DV (or any decodable) file to H.264 + AAC Matroska (the
counterpart of ``scripts/encode_video.py``): ``--crf``, ``--preset``,
``--16x9``, ``--max-bitrate`` and ``-f``; DV's sample aspect ratio (10:11,
or 40:33 widescreen); the output path derived from the input when
omitted. The video goes through ``DVReconstructionFilter`` on the card
before x264. Needs FFmpeg's development files where the native library
is built.

    python -m canvas_tpu_torch.tools.encode_video IN.dv [OUT.mkv]
        [--crf 23] [--preset slow] [--16x9] [--max-bitrate KBPS] [-f]
        [--frames N] [--device cpu]
"""

import argparse
import fractions
import os
import sys

from canvas_tpu_torch.tools import _media, add_device_argument, on_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('in_path')
    parser.add_argument('out_path', default=None, nargs='?')
    parser.add_argument('-f', dest='force', default=False,
                        action='store_true')
    parser.add_argument('--crf', type=float, default=23.0)
    parser.add_argument('--preset', dest='preset', default='slow')
    parser.add_argument('--16x9', dest='wide', default=False,
                        action='store_true')
    parser.add_argument('--max-bitrate', dest='max_bitrate', type=int,
                        default=None)
    parser.add_argument('--frames', type=int, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    if not args.out_path:
        root = args.in_path.rsplit('.', 1)[0]
        args.out_path = '{0}-crf{1:g}-{2}.mkv'.format(root, args.crf,
                                                      args.preset)
    if os.path.isfile(args.out_path) and not args.force:
        print('The output file already exists. '
              'Will not overwrite without -f.')
        return 1

    from canvas_tpu_torch import x264

    with on_device(args.device) as device:
        video, audio, rate = _media.probe(args.in_path)
        frame_count = args.frames or video.frame_count or 300
        source, width, height = _media.video_source(args.in_path, video)
        sar = (fractions.Fraction(40, 33) if args.wide
               else fractions.Fraction(10, 11))
        params = x264.X264EncoderParams(
            preset=args.preset, width=width, height=height, frame_rate=rate,
            constant_ratefactor=args.crf, sample_aspect_ratio=sar,
            vbv_max_bitrate=args.max_bitrate)
        vencoder = x264.X264VideoEncoder(source, 0, frame_count - 1, params,
                                         device=device)
        aencoder, sample_rate = (
            _media.aac_encoder(args.in_path, frame_count, rate)
            if audio is not None else (None, 48000))
        count = _media.write_mkv(
            args.out_path, 'canvas_tpu_torch encode_video', vencoder, width,
            height, rate, aencoder, sample_rate)
    print('wrote %d frames to %s' % (count, args.out_path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
