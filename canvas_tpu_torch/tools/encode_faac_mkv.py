"""Encode a file's audio track to AAC in Matroska, audio only (the
counterpart of ``scripts/encode_faac_mkv.py``): demux ->
``AVAudioDecoder`` -> ``AACAudioEncoder`` -> the Matroska writer. It
runs on the host only, and needs FFmpeg's development files where the
native library is built.

    python -m canvas_tpu_torch.tools.encode_faac_mkv INPUT [OUTPUT.mkv]
        [SECONDS]
"""

import argparse
import sys

from canvas_tpu_torch import faac, libav, matroska


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('in_path', metavar='INPUT')
    ap.add_argument('out_path', nargs='?', default='test_audio.mkv')
    ap.add_argument('seconds', nargs='?', type=float, default=30.0)
    args = ap.parse_args(argv)

    adec = libav.AVAudioDecoder(args.in_path, channels=2)
    sample_rate = adec.sample_rate
    n_samples = int(args.seconds * sample_rate)
    encoder = faac.AACAudioEncoder(adec, 0, n_samples - 1,
                                   sample_rate=sample_rate, channels=2)

    with open(args.out_path, 'wb') as fd:
        writer = matroska.MatroskaWriter(fd)
        writer.write_start(writing_app='canvas_tpu_torch encode_faac_mkv',
                           duration=0.0, timecode_scale=1_000_000)
        writer.write_tracks([matroska.Track(
            number=1, uid=1, type_=matroska.TrackType.AUDIO,
            codec_id='A_AAC', lacing=False,
            codec_private=encoder.get_header(),
            audio=matroska.TrackAudio(sample_rate, channels=2))])
        count = 0
        last_pts = 0
        while True:
            packet = encoder.get_next_packet()
            if packet is None:
                break
            last_pts = packet.pts
            writer.write_simple_block(
                1, int(packet.pts * 1000 / sample_rate), packet.data,
                keyframe=True)
            count += 1
        writer.write_end(duration=float(last_pts * 1000 / sample_rate))
    print('wrote %d AAC packets to %s' % (count, args.out_path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
