"""What the encoding tools share: a media file's video as a source, and
the H.264 (+ AAC) Matroska writer."""

import fractions

from canvas_tpu_torch import libav, matroska

NS = 1_000_000_000


def probe(path):
    """(video stream, audio stream or None, frame rate) of *path*."""
    container = libav.AVContainer(path)
    try:
        video = next(s for s in container.streams if s.type == 'video')
        audio = next((s for s in container.streams if s.type == 'audio'),
                     None)
    finally:
        container.close()
    rate = video.real_frame_rate or fractions.Fraction(30000, 1001)
    return video, audio, rate


def video_source(path, video):
    """(source, width, height) of *path*'s video: DV through
    ``DVReconstructionFilter`` at 720x480, anything else through the
    decoder's RGBA."""
    from canvas_tpu_torch import process
    decoder = libav.AVVideoDecoder(path)
    if video.codec == 'dvvideo':
        return process.DVReconstructionFilter(decoder), 720, 480
    from canvas_tpu_torch.editor.plugins.libav_plugin import \
        _RgbaDecoderSource
    width, height = video.frame_size
    return _RgbaDecoderSource(decoder, width, height), width, height


def write_mkv(out_path, writing_app, vencoder, width, height, frame_rate,
              aencoder=None, sample_rate=48000):
    """Mux *vencoder*'s H.264 packets (track 1) and *aencoder*'s AAC
    packets (track 2), interleaved in presentation order, into Matroska
    at *out_path*. Returns the count of video packets."""
    with open(out_path, 'wb') as fd:
        writer = matroska.MatroskaWriter(fd)
        writer.write_start(writing_app=writing_app, duration=0.0,
                           timecode_scale=1_000_000)
        tracks = [matroska.Track(
            number=1, uid=1, type_=matroska.TrackType.VIDEO,
            codec_id='V_MPEG4/ISO/AVC', lacing=False,
            default_duration=int(NS / frame_rate),
            codec_private=vencoder.get_header(),
            video=matroska.TrackVideo(width, height))]
        if aencoder is not None:
            tracks.append(matroska.Track(
                number=2, uid=2, type_=matroska.TrackType.AUDIO,
                codec_id='A_AAC', lacing=False,
                codec_private=aencoder.get_header(),
                audio=matroska.TrackAudio(sample_rate, channels=2)))
        writer.write_tracks(tracks)

        streams = [(1, vencoder.get_next_packet,
                    lambda p: p.pts * frame_rate.denominator * 1000 /
                    frame_rate.numerator,
                    lambda p: p.keyframe)]
        if aencoder is not None:
            streams.append((2, aencoder.get_next_packet,
                            lambda p: p.pts * 1000 / sample_rate,
                            lambda p: True))
        count = matroska.write_interleaved_blocks(writer, streams)[1]
        writer.write_end(duration=float(
            count * frame_rate.denominator * 1000 / frame_rate.numerator))
    return count


def aac_encoder(path, frames, frame_rate):
    """An AAC encoder of *path*'s audio over as many samples as *frames*
    frames at *frame_rate* last, and its sample rate."""
    from canvas_tpu_torch import faac
    adec = libav.AVAudioDecoder(path, channels=2)
    rate = adec.sample_rate
    n_samples = int(frames * rate * frame_rate.denominator /
                    frame_rate.numerator)
    return (faac.AACAudioEncoder(adec, 0, n_samples - 1, sample_rate=rate,
                                 channels=2), rate)
