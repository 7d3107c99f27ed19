"""AAC encoding module.

API-parity equivalent of the reference's faac module
(src/faac/AACAudioEncoder.c:49-270), implemented over
the native canvas_av packet encoder with avcodec's AAC encoder.
AACAudioEncoder(source, start_sample, end_sample, sample_rate, channels,
bit_rate) is a codec packet source: get_next_packet() + get_header()
(AudioSpecificConfig).
"""

from canvas_tpu_torch import libav

__all__ = ['AACAudioEncoder']


class AACAudioEncoder(libav.AVAudioEncoder):
    def __init__(self, source, start_sample, end_sample, sample_rate=48000,
                 channels=2, bit_rate=128000):
        libav.AVAudioEncoder.__init__(
            self, source, start_sample, end_sample, codec='aac',
            sample_rate=sample_rate, channels=channels, bit_rate=bit_rate)
        self._pts_base = None

    def get_next_packet(self):
        """Packets with pts rebased to start at 0: libfaac (what the
        reference wraps, AACAudioEncoder.c) numbers output frames from
        zero, while avcodec's aac encoder emits priming pts < 0 — the
        reference's muxing scripts feed pts straight into UNSIGNED
        Matroska timecodes (scripts/encode_faac_mkv.py:78-83), so the
        negative head must be rebased for them to run unchanged."""
        pkt = libav.AVAudioEncoder.get_next_packet(self)
        if pkt is not None and pkt.pts is not None:
            if self._pts_base is None:
                self._pts_base = pkt.pts
            if self._pts_base < 0:
                pkt.pts -= self._pts_base
                if pkt.dts is not None:
                    pkt.dts -= self._pts_base
        return pkt
