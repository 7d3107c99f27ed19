"""DV decoding module.

API-parity equivalent of the reference's libdv module
(src/libdv/: DVVideoDecoder.c, DVAudioDecoder.c),
implemented over the native canvas_av layer (avcodec's DV codec instead
of the libdv library — same streams, same planar 4:1:1 output consumed
by DVReconstructionFilter).
"""

from canvas_tpu_torch import libav

__all__ = ['DVVideoDecoder', 'DVAudioDecoder']


class DVVideoDecoder(libav.AVVideoDecoder):
    """DV packet stream -> planar coded images
    (DVVideoDecoder.c:58-230)."""

    def __init__(self, source, stream=None):
        libav.AVVideoDecoder.__init__(self, source, codec='dvvideo',
                                      stream=stream)


class DVAudioDecoder(libav.AVAudioDecoder):
    """DV audio (AAUX) -> audio source (DVAudioDecoder.c:76-447). The
    AAUX parsing the reference does by hand lives inside avcodec's DV
    demuxer/decoder.

    The reference feeds this the VIDEO packet stream (DV audio lives
    inside the video DIF blocks — its scripts build it over
    ``AVDemuxer(path, 0)``, e.g. scripts/encode-video.py:74-75); in
    avformat terms the dv demuxer extracts that AAUX audio as the
    container's audio stream, so a stream that turns out to carry
    dvvideo resolves to the file's FIRST AUDIO stream here."""

    def __init__(self, source, channels=2, stream=None):
        # Only the demuxer's IMPLICIT stream is remapped; an explicit
        # stream= argument is the caller's choice and stands.
        if stream is None and isinstance(source, libav.AVDemuxer):
            pick = source.stream
            try:
                info = libav.AVContainer(source.filename)
            except IOError as e:
                import logging as _stdlog
                _stdlog.getLogger('canvas_tpu_torch.libdv').warning(
                    'could not probe %s to resolve the DV audio '
                    'stream (%s); using stream %d as-is',
                    source.filename, e, pick)
            else:
                streams = info.streams
                if (0 <= pick < len(streams)
                        and streams[pick].type != 'audio'
                        and streams[pick].codec == 'dvvideo'):
                    stream = next((i for i, s in enumerate(streams)
                                   if s.type == 'audio'), pick)
                info.close()
        libav.AVAudioDecoder.__init__(self, source, channels=channels,
                                      stream=stream)
