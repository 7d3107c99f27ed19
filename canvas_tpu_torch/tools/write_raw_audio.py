"""Write a float-PCM Matroska from a synthetic audio source (the
counterpart of ``scripts/write_raw_audio.py``): two seconds of a 440 Hz
tone, stereo at 48 kHz. It runs on the host only.

    python -m canvas_tpu_torch.tools.write_raw_audio [OUT.mkv]
"""

import argparse
import math
import sys

import numpy as np

from canvas_tpu_torch import matroska
from canvas_tpu_torch.audio import AudioSource


class ToneSource(AudioSource):
    def __init__(self, freq=440.0, rate=48000):
        self.freq = freq
        self.rate = rate

    def _render(self, frame):
        t = np.arange(frame.full_min_sample,
                      frame.full_max_sample + 1) / self.rate
        tone = 0.5 * np.sin(2 * math.pi * self.freq * t)
        frame.data = np.repeat(tone[:, None],
                               frame.channels, 1).astype(np.float32)
        frame.current_min_sample = frame.full_min_sample
        frame.current_max_sample = frame.full_max_sample


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('out_path', nargs='?', default='tone.mkv')
    args = ap.parse_args(argv)
    matroska.write_audio_pcm_float(args.out_path, ToneSource(), 0,
                                   48000 * 2 - 1, 48000, 2)
    print('wrote', args.out_path)
    return 0


if __name__ == '__main__':
    sys.exit(main())
