"""Audio round trip (the counterpart of ``scripts/test_audio.py``,
renamed so that no ``test_*`` module sits in the package): a file's
audio stream, or a generated 440 Hz stereo tone, AAC-encoded into
Matroska with an explicit Track and SimpleBlock loop; the written file
is then decoded and compared sample by sample with the input. It runs on
the host only, and needs FFmpeg's development files where the native
library is built.

    python -m canvas_tpu_torch.tools.audio_roundtrip [INPUT|-] [OUT.mkv]
"""

import argparse
import math
import sys

import numpy as np

from canvas_tpu_torch import faac, libav, matroska
from canvas_tpu_torch.audio import AudioFrame

SAMPLE_RATE = 48000
N_SAMPLES = 10000


class ToneSource:
    """440 Hz stereo test tone (stand-in input when none is given)."""

    def get_frame(self, min_sample, max_sample, channels):
        n = max_sample - min_sample + 1
        t = np.arange(min_sample, max_sample + 1) / SAMPLE_RATE
        data = np.zeros((n, channels), np.float32)
        for ch in range(channels):
            data[:, ch] = 0.4 * np.sin(2 * math.pi * 440 * t + ch)
        return AudioFrame(min_sample, max_sample, channels, data=data)


def write_aac_mkv(encoder, out_path):
    """Mux *encoder*'s packets, timecodes rebased on the first packet's
    pts (AAC priming makes it negative; Matroska timecodes are unsigned),
    and return how many were written."""
    ns = 1000000000
    timescale = 10000
    with open(out_path, 'wb') as stream:
        writer = matroska.MatroskaWriter(stream)
        writer.write_start(writing_app='canvas_tpu_torch audio_roundtrip',
                           duration=0.0, timecode_scale=timescale)
        header = encoder.get_header()
        print('Len(header): ' + str(len(header)))
        writer.write_tracks([matroska.Track(
            number=1, uid=1, type_=matroska.TrackType.AUDIO,
            codec_id='A_AAC', lacing=False,
            # the Matroska codec specs say otherwise: the header is needed
            codec_private=header,
            audio=matroska.TrackAudio(SAMPLE_RATE, channels=2))])
        written = 0
        last = 0
        base = None
        try:
            packet = encoder.get_next_packet()
            while packet:
                if base is None:
                    base = packet.pts
                raw = round(float((packet.pts - base) * ns)
                            / float(SAMPLE_RATE))
                timecode = int(round(raw / timescale))
                writer.write_simple_block(1, timecode, packet.data,
                                          keyframe=packet.keyframe)
                written += 1
                last = timecode
                packet = encoder.get_next_packet()
        finally:
            writer.write_end(duration=float(last))
    return written


def encoder_delay(probe, orig):
    """The shift of the decoded stream *probe* against *orig* (the AAC
    priming samples at its head), found by scanning shifts on channel 0,
    coarse and then to the sample."""
    def scan(lo, hi, step):
        best = (None, 0)
        for s in range(max(lo, 0), hi, step):
            err = float(np.mean(np.abs(probe[s + 512:s + 1536, 0]
                                       - orig[512:1536, 0])))
            if best[0] is None or err < best[0]:
                best = (err, s)
        return best[1]

    delay = scan(0, 4096, 16)
    return scan(delay - 16, delay + 17, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('in_path', nargs='?', default='-', metavar='INPUT')
    ap.add_argument('out_path', nargs='?', default='test_audio.mkv')
    args = ap.parse_args(argv)

    if args.in_path not in ('', '-'):
        decoder = libav.AVAudioDecoder(libav.AVDemuxer(args.in_path, 1),
                                       'pcm_s16le', 2)
    else:
        print('no input file given; using a generated 440 Hz tone')
        decoder = ToneSource()
    encoder = faac.AACAudioEncoder(decoder, 0, N_SAMPLES, SAMPLE_RATE, 2)
    written = write_aac_mkv(encoder, args.out_path)
    print('%d AAC frames -> %s' % (written, args.out_path))

    decoded = libav.AVAudioDecoder(args.out_path, 'aac', 2)
    frame_orig = decoder.get_frame(0, N_SAMPLES, 2)
    delay = encoder_delay(
        np.asarray(decoded.get_frame(0, N_SAMPLES + 4096, 2).data),
        np.asarray(frame_orig.data))
    print('estimated encoder delay: %d samples' % delay)
    frame_dec = decoded.get_frame(delay, N_SAMPLES + delay, 2)

    worst = 0.0
    # Interior samples only: the head is encoder priming and the last
    # partial AAC frame is dropped, so the first and last ~kilosample are
    # edge effects, not the codec's fidelity.
    for i in range(1000, N_SAMPLES - 2000 + 1, 1000):
        l1, r1 = frame_orig.sample(i, 0), frame_orig.sample(i, 1)
        l2, r2 = (frame_dec.sample(i + delay, 0),
                  frame_dec.sample(i + delay, 1))
        worst = max(worst, abs(l1 - l2), abs(r1 - r2))
        print('{4:05} L{0:+0.4f} R{1:+0.4f} vs L{2:+0.4f} R{3:+0.4f}'
              .format(l1, r1, l2, r2, i))
    print('worst sampled delta: %.4f' % worst)
    return 0


if __name__ == '__main__':
    sys.exit(main())
