"""Media IO: demux/decode/encode/mux via the native canvas_av library
(the port's counterpart of ``canvas_tpu/libav.py``).

Python face of native/canvas_av.cpp (the C++ equivalent of the
reference's src/libav module). API parity map:

  reference (fluggo.media.libav)      canvas_tpu_torch.libav
  --------------------------------    ---------------------------------
  AVContainer / AVStream (probe)      AVContainer / AVStreamInfo
  AVDemuxer (packet source)           AVDemuxer (CodecPacketSource)
  AVVideoDecoder (coded images)       AVVideoDecoder (CodedImageSource)
  AVAudioDecoder (audio source)       AVAudioDecoder (AudioSource-like)
  AVVideoEncoder + AVMuxer            AVMuxer (encoders owned natively)
  write_video                         write_video

Design difference (deliberate): the reference pipes every packet through
Python between the demuxer and decoder (PyCapsule vtables,
AVDemuxer.c:220-222); here decoders own their demuxer natively so the
decode loop never crosses the language boundary. The packet-level
AVDemuxer remains for packet workflows (e.g. the Matroska muxer).

The native library is built at first use from ``native/`` with make,
into ``canvas_tpu_torch/_build/native/<hash of canvas_av.cpp and the
Makefile>/libcanvas_av.so`` (``_library_path``): an edit to either
source builds a new library beside the old one, and a build or load
failure raises with make's output. ``write_video`` and
``AVVideoEncoder`` render through ``canvas_tpu_torch.render.RenderPlanner``
on the card unless the caller passes ``device='cpu'``.
"""

import ctypes
import errno
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from canvas_tpu_torch import backend, profiling
from canvas_tpu_torch.audio import AudioFrame, AudioSource
from canvas_tpu_torch.basetypes import box2i
from canvas_tpu_torch.coded import (CodecPacketSource, CodedImage,
                                    CodedImageSource)
from canvas_tpu_torch.mesh import Mesh
from canvas_tpu_torch.ops import color as color_ops

__all__ = ['available', 'AVContainer', 'AVStreamInfo', 'AVDemuxer',
           'CodecPacket', 'AVVideoDecoder', 'AVAudioDecoder', 'AVMuxer',
           'write_video']

_NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           '_build', 'native')
_lib = None
_lib_lock = threading.Lock()


class _CavStreamInfo(ctypes.Structure):
    _fields_ = [
        ('type', ctypes.c_int32),
        ('codec_name', ctypes.c_char * 32),
        ('width', ctypes.c_int32), ('height', ctypes.c_int32),
        ('pix_fmt', ctypes.c_char * 32),
        ('frame_rate_num', ctypes.c_int32),
        ('frame_rate_den', ctypes.c_int32),
        ('sar_num', ctypes.c_int32), ('sar_den', ctypes.c_int32),
        ('time_base_num', ctypes.c_int32),
        ('time_base_den', ctypes.c_int32),
        ('duration', ctypes.c_int64),
        ('nb_frames', ctypes.c_int64),
        ('sample_rate', ctypes.c_int32),
        ('channels', ctypes.c_int32),
        ('start_time', ctypes.c_int64),
    ]


class _CavContainerInfo(ctypes.Structure):
    _fields_ = [
        ('format_long_name', ctypes.c_char * 128),
        ('mime_type', ctypes.c_char * 64),
        ('duration', ctypes.c_int64),
        ('bit_rate', ctypes.c_int64),
    ]


class _CavStreamExtra(ctypes.Structure):
    _fields_ = [
        ('id', ctypes.c_int32),
        ('bit_rate', ctypes.c_int64),
        ('codec_long_name', ctypes.c_char * 96),
    ]


class _CavPacket(ctypes.Structure):
    _fields_ = [
        ('data', ctypes.POINTER(ctypes.c_uint8)),
        ('size', ctypes.c_int32),
        ('pts', ctypes.c_int64), ('dts', ctypes.c_int64),
        ('duration', ctypes.c_int64),
        ('keyframe', ctypes.c_int32),
        ('stream', ctypes.c_int32),
    ]


def _library_path():
    """Where the library of the checkout's ``native/`` sources lives: a
    directory named by the hash of ``canvas_av.cpp`` and the Makefile,
    so a library built from other sources is never loaded."""
    digest = hashlib.sha256()
    for name in ('canvas_av.cpp', 'Makefile'):
        with open(os.path.join(_NATIVE_SRC, name), 'rb') as f:
            digest.update(name.encode())
            digest.update(f.read())
    return os.path.join(_BUILD_ROOT, digest.hexdigest()[:16],
                        'libcanvas_av.so')


def _build_library(path):
    """Build the library into *path* with ``make -C native BUILDDIR=``:
    into a private directory first, then renamed into place, so
    processes that build at once each load a whole library and the
    last rename wins. Raises with make's output when the build fails."""
    os.makedirs(_BUILD_ROOT, exist_ok=True)
    work = tempfile.mkdtemp(prefix='build.', dir=_BUILD_ROOT)
    try:
        proc = subprocess.run(['make', '-C', _NATIVE_SRC,
                               'BUILDDIR=' + work],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                'building %s failed (make exit code %d):\n%s%s'
                % (path, proc.returncode, proc.stdout, proc.stderr))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        os.replace(os.path.join(work, 'libcanvas_av.so'), path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _load():
    """The loaded native library, built at first use (``_library_path``).
    Loaded with ``RTLD_LOCAL``, ctypes' default, and its signatures set
    on this handle only: another copy of the library in the process
    (the JAX package's) keeps its own."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not os.path.exists(path):
            _build_library(path)
        lib = ctypes.CDLL(path)

        lib.cav_open.restype = ctypes.c_void_p
        lib.cav_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int]
        lib.cav_close.argtypes = [ctypes.c_void_p]
        lib.cav_stream_count.argtypes = [ctypes.c_void_p]
        lib.cav_format_name.restype = ctypes.c_char_p
        lib.cav_format_name.argtypes = [ctypes.c_void_p]
        lib.cav_stream_info.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(_CavStreamInfo)]
        lib.cav_container_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_CavContainerInfo)]
        lib.cav_stream_extra.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_CavStreamExtra)]
        lib.cav_read_packet.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(_CavPacket)]
        lib.cav_packet_free.argtypes = [ctypes.POINTER(_CavPacket)]
        lib.cav_seek.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int]

        lib.cav_video_decoder_open.restype = ctypes.c_void_p
        lib.cav_video_decoder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.cav_video_decoder_close.argtypes = [ctypes.c_void_p]
        lib.cav_video_decode_rgba.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        lib.cav_video_decode_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int64, ctypes.c_int64]
        lib.cav_video_decoder_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_CavStreamInfo)]
        lib.cav_video_decoder_color_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]

        lib.cav_audio_decoder_open.restype = ctypes.c_void_p
        lib.cav_audio_decoder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int]
        lib.cav_audio_decoder_close.argtypes = [ctypes.c_void_p]
        lib.cav_audio_decoder_channels.argtypes = [ctypes.c_void_p]
        lib.cav_audio_decoder_sample_rate.argtypes = [ctypes.c_void_p]
        lib.cav_audio_decode.restype = ctypes.c_int64
        lib.cav_audio_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]

        lib.cav_muxer_create.restype = ctypes.c_void_p
        lib.cav_muxer_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_char_p, ctypes.c_int]
        lib.cav_muxer_add_video.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.cav_muxer_add_video_ex.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.cav_muxer_add_audio.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        lib.cav_muxer_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int]
        lib.cav_muxer_write_video.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.cav_muxer_write_video_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        lib.cav_muxer_write_audio.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.cav_muxer_finish.argtypes = [ctypes.c_void_p]
        lib.cav_muxer_add_copy_video.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.cav_muxer_set_extradata.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int]
        lib.cav_muxer_write_packet.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int]
        lib.cav_version.restype = ctypes.c_char_p
        _lib = lib
        return lib


def available():
    """True if the port's native library builds and loads here (False,
    never an exception, where FFmpeg's development files are missing)."""
    try:
        _load()
        return True
    except Exception:
        return False


def _as_frame_rate(value):
    """Fraction from any rate spec — (n, d) tuples like the rest of the
    API (process._rate), v2i, Fraction, int; floats snap to a sane
    ratio (Fraction(30000/1001) is an exact binary fraction with a
    ~10^15 denominator avcodec rejects)."""
    from fractions import Fraction
    if isinstance(value, float):
        return Fraction(value).limit_denominator(65535)
    if isinstance(value, (tuple, list)) and len(value) == 2:
        return Fraction(int(value[0]), int(value[1]))
    if hasattr(value, 'x') and hasattr(value, 'y'):   # v2i rate
        return Fraction(int(value.x), int(value.y))
    rate = Fraction(value)
    if rate.denominator > 1 << 24 or rate.numerator > 1 << 30:
        # A Fraction built FROM a float (e.g. the reference
        # test_packets.py's Fraction(30000/1001)) carries a ~10^15
        # denominator that overflows avcodec's int timebase — snap it.
        rate = rate.limit_denominator(65535)
    return rate


def _err_buf():
    return ctypes.create_string_buffer(512)


# --------------------------------------------------------------------------

class AVStreamInfo:
    """Probed stream metadata (reference AVContainer/AVStream,
    src/libav/AVContainer.c:65-358)."""

    def __init__(self, raw, index=None, extra=None):
        self.type = {0: 'video', 1: 'audio', 2: 'other'}[raw.type]
        self.codec = raw.codec_name.decode()
        # reference AVStream getters (AVContainer.c:254-343)
        self.index = index
        self.id = extra.id if extra is not None else None
        self.bit_rate = (int(extra.bit_rate) or None) if extra is not None \
            else None
        self.encoding = (extra.codec_long_name.decode() or None) \
            if extra is not None else None
        self.frame_size = (raw.width, raw.height)
        self.pixel_format = raw.pix_fmt.decode()
        from fractions import Fraction
        self.real_frame_rate = (Fraction(raw.frame_rate_num,
                                         raw.frame_rate_den)
                                if raw.frame_rate_den else None)
        self.sample_aspect_ratio = (Fraction(raw.sar_num, raw.sar_den)
                                    if raw.sar_den and raw.sar_num else None)
        self.time_base = (Fraction(raw.time_base_num, raw.time_base_den)
                          if raw.time_base_den else None)
        # Non-positive (incl. the AV_NOPTS_VALUE sentinel, whose raw
        # -2^63 is truthy and would satisfy `if duration:`) -> None,
        # the reference getters' convention (AVContainer.c:318-332
        # return None for start_time/duration <= 0).
        self.duration = raw.duration if raw.duration > 0 else None
        self.frame_count = raw.nb_frames
        self.sample_rate = raw.sample_rate
        self.channels = raw.channels
        self.start_time = (raw.start_time if raw.start_time > 0
                           else None)


class AVContainer:
    """Container probe (the reference `probe` script's backend)."""

    def __init__(self, filename):
        lib = _load()
        err = _err_buf()
        self._handle = lib.cav_open(filename.encode(), err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())
        self.format_name = lib.cav_format_name(self._handle).decode()
        # container-level metadata (reference AVContainer getters)
        cinfo = _CavContainerInfo()
        lib.cav_container_info(self._handle, ctypes.byref(cinfo))
        self.format_long_name = cinfo.format_long_name.decode()
        self.mime_type = cinfo.mime_type.decode() or None
        self.duration = int(cinfo.duration)       # microseconds
        self.bit_rate = int(cinfo.bit_rate) or None
        self.streams = []
        for i in range(lib.cav_stream_count(self._handle)):
            raw = _CavStreamInfo()
            lib.cav_stream_info(self._handle, i, ctypes.byref(raw))
            extra = _CavStreamExtra()
            lib.cav_stream_extra(self._handle, i, ctypes.byref(extra))
            self.streams.append(AVStreamInfo(raw, index=i, extra=extra))

    def close(self):
        if self._handle:
            _load().cav_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class CodecPacket:
    """One coded packet (reference codec_packet, framework.h:420-433;
    ``discardable`` is its B-frame droppable flag)."""

    __slots__ = ('data', 'pts', 'dts', 'duration', 'keyframe', 'stream',
                 'discardable')

    def __init__(self, data, pts, dts, duration, keyframe, stream,
                 discardable=False):
        self.data = data
        self.pts = pts
        self.dts = dts
        self.duration = duration
        self.keyframe = keyframe
        self.stream = stream
        self.discardable = discardable


class AVDemuxer(CodecPacketSource):
    """Codec packet source for one stream of a file
    (src/libav/AVDemuxer.c:60-222): get_next_packet() and seek(ts)."""

    def __init__(self, filename, stream):
        lib = _load()
        err = _err_buf()
        self.filename = filename
        self.stream = int(stream)
        self._handle = lib.cav_open(filename.encode(), err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())

    def get_next_packet(self):
        lib = _load()
        pkt = _CavPacket()
        rc = lib.cav_read_packet(self._handle, self.stream,
                                 ctypes.byref(pkt))
        if rc == 0:
            return None
        if rc < 0:
            raise IOError('read_packet failed: %d' % rc)
        data = ctypes.string_at(pkt.data, pkt.size)
        lib.cav_packet_free(ctypes.byref(pkt))
        return CodecPacket(data, pkt.pts, pkt.dts, pkt.duration,
                           bool(pkt.keyframe), pkt.stream)

    def seek(self, ts):
        rc = _load().cav_seek(self._handle, self.stream, int(ts), 1)
        if rc < 0:
            raise IOError('seek failed: %d' % rc)

    def close(self):
        if self._handle:
            _load().cav_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AVVideoDecoder(CodedImageSource):
    """Frame-accurate video decoder producing planar coded images
    (src/libav/AVVideoDecoder.c:128-301).

    Accepts a filename (native demux) or an AVDemuxer (its file/stream is
    reused — the decode loop stays in C++, unlike the reference's
    per-packet Python crossing).
    """

    def __init__(self, source, codec=None, stream=None):
        lib = _load()
        err = _err_buf()
        if isinstance(source, AVDemuxer):
            filename = source.filename
            stream = source.stream if stream is None else stream
        else:
            filename = source
            stream = -1 if stream is None else int(stream)
        self._handle = lib.cav_video_decoder_open(filename.encode(), stream,
                                                  err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())
        self._lock = threading.Lock()
        # Reusable plane buffers sized from the probed stream dimensions
        # (reallocated if a frame turns out larger — dimensions can
        # change mid-stream, and the native layer bounds-checks against
        # the capacities we pass rather than trusting the file).
        info = _CavStreamInfo()
        lib.cav_video_decoder_info(self._handle, ctypes.byref(info))
        self._alloc_planes(max(info.width * info.height, 1024))

    def _alloc_planes(self, y_bytes, c_bytes=None):
        # chroma starts at luma/2 (covers 4:1:1/4:2:0/4:2:2); a 4:4:4
        # stream reports exact dims via the -1001 retry path and grows
        self._y = np.empty((int(y_bytes),), np.uint8)
        c = int(c_bytes) if c_bytes is not None else (int(y_bytes) + 1) // 2
        self._cb = np.empty((c,), np.uint8)
        self._cr = np.empty((c,), np.uint8)

    def get_frame(self, frame_index, quality=0):
        """Planar YCbCr CodedImage for *frame_index*, or None at EOF."""
        lib = _load()
        dims = (ctypes.c_int * 6)()
        with self._lock:
            for _attempt in range(2):
                rc = lib.cav_video_decode_planar(
                    self._handle, int(frame_index),
                    self._y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._cb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._cr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    dims, self._y.size, self._cb.size)
                if rc != -1001:
                    break
                # Frame larger than our buffers: grow to the reported
                # dims and retry (the frame was consumed; re-decode).
                self._alloc_planes(dims[0] * dims[1],
                                   c_bytes=dims[2] * dims[3])
        if rc == 0:
            return None
        if rc == -1000:
            raise ValueError('decoded format is not planar 8-bit YCbCr')
        if rc < 0:
            raise IOError('decode failed: %d' % rc)
        yw, yh, cw, ch = dims[0], dims[1], dims[2], dims[3]
        return CodedImage([
            self._y[:yw * yh].reshape(yh, yw).copy(),
            self._cb[:cw * ch].reshape(ch, cw).copy(),
            self._cr[:cw * ch].reshape(ch, cw).copy()])

    def color_info(self):
        """('tv'|'pc'|'unknown', 'bt709'|'bt601'|'unknown') from the
        stream metadata (+ the yuvj pixel-format full-range convention)
        — drives reconstruction-path/matrix selection."""
        lib = _load()
        r = ctypes.c_int32()
        sp = ctypes.c_int32()
        lib.cav_video_decoder_color_info(self._handle, ctypes.byref(r),
                                         ctypes.byref(sp))
        info = _CavStreamInfo()
        lib.cav_video_decoder_info(self._handle, ctypes.byref(info))
        pix = info.pix_fmt.decode()
        rng = {1: 'tv', 2: 'pc'}.get(r.value, 'unknown')
        if rng == 'unknown' and pix.startswith('yuvj'):
            rng = 'pc'
        space = {1: 'bt709'}.get(sp.value)
        if space is None and sp.value in (5, 6):   # bt470bg / smpte170m
            space = 'bt601'
        return rng, (space or 'unknown')

    def get_frame_rgba(self, frame_index, width, height):
        """Decoded frame converted to (H, W, 4) RGBA u8 (swscale)."""
        lib = _load()
        out = np.empty((height, width, 4), np.uint8)
        with self._lock:
            rc = lib.cav_video_decode_rgba(
                self._handle, int(frame_index),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                width, height)
        if rc == 0:
            return None
        if rc < 0:
            raise IOError('decode failed: %d' % rc)
        return out

    def close(self):
        # under _lock: closing during an in-flight decode on another
        # thread (editor source swap) would free the codec contexts out
        # from under the native call — use-after-free
        with self._lock:
            if self._handle:
                _load().cav_video_decoder_close(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AVAudioDecoder(AudioSource):
    """Audio source decoding a file's audio stream
    (src/libav/AVAudioDecoder.c:100-492). get_frame(min, max, channels)
    mirrors the reference audio pull protocol."""

    def __init__(self, source, codec=None, channels=2, stream=None):
        lib = _load()
        err = _err_buf()
        if isinstance(source, AVDemuxer):
            filename = source.filename
            stream = source.stream if stream is None else stream
        else:
            filename = source
            stream = -1 if stream is None else int(stream)
        self._handle = lib.cav_audio_decoder_open(
            filename.encode(), stream, int(channels), err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())
        self.channels = lib.cav_audio_decoder_channels(self._handle)
        self.sample_rate = lib.cav_audio_decoder_sample_rate(self._handle)
        self._lock = threading.Lock()

    def get_frame(self, min_sample, max_sample, channels=None):
        channels = self.channels if channels is None else int(channels)
        count = max_sample - min_sample + 1
        buf = np.zeros((count, self.channels), np.float32)
        with self._lock:
            rc = _load().cav_audio_decode(
                self._handle, int(min_sample), int(max_sample),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc < 0:
            # mid-stream read/decode error (NOT eof): don't hand the
            # mixdown silence where there should be audio
            raise IOError('audio decode failed: %d' % rc)
        data = np.zeros((count, channels), np.float32)
        n = min(channels, self.channels)
        data[:, :n] = buf[:, :n]
        return AudioFrame(min_sample, max_sample, channels, data=data)

    def _render(self, frame):
        pulled = self.get_frame(frame.full_min_sample,
                                frame.full_max_sample, frame.channels)
        frame.data = pulled.data
        frame.current_min_sample = frame.full_min_sample
        frame.current_max_sample = frame.full_max_sample

    def close(self):
        with self._lock:
            if self._handle:
                _load().cav_audio_decoder_close(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AVMuxer:
    """Multi-stream encoder+muxer (src/libav/AVMuxer.c:70-245 +
    AVVideoEncoder.c). add_video_stream/add_audio_stream then write
    frames; close() finalizes the file."""

    def __init__(self, filename, format=''):
        lib = _load()
        err = _err_buf()
        self._handle = lib.cav_muxer_create(filename.encode(),
                                            format.encode(), err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())
        self._started = False
        self._video_dims = {}       # stream idx -> (w, h)
        self._audio_channels = {}   # stream idx -> channels
        self._copy_streams = {}     # stream idx -> {'source', 'rate'}

    def add_video_stream(self, *args, **kw):
        """Add an ENCODING video stream:
        ``add_video_stream(codec, frame_size, frame_rate, bit_rate=0,
        options='', sample_aspect_ratio=None, interlaced=False,
        top_field_first=False)`` — sample_aspect_ratio (Fraction; DV
        NTSC 4:3 is 10/11), interlaced and top_field_first mirror the
        reference AVVideoEncoder kwargs (src/libav/AVVideoEncoder.c).

        The reference calling convention is also accepted
        (src/libav/AVMuxer.c:144-210): ``add_video_stream(source,
        codec, frame_rate, frame_size, sample_aspect_ratio)`` where
        *source* is a CodecPacketSource — adds a STREAM-COPY stream
        whose pre-encoded packets :meth:`run` pumps into the file."""
        if args and not isinstance(args[0], str):
            # reference style: (source, codec, frame_rate, frame_size,
            # sample_aspect_ratio)
            names = ['source', 'codec', 'frame_rate', 'frame_size',
                     'sample_aspect_ratio']
            if len(args) > len(names):
                raise TypeError('too many positional arguments')
            params = dict(zip(names, args))
            for k, v in kw.items():
                if k not in names:
                    raise TypeError('unexpected kwarg %r' % k)
                if k in params:
                    raise TypeError('multiple values for %r' % k)
                params[k] = v
            return self._add_copy_video_stream(
                params['source'], params['codec'],
                params.get('frame_rate'), params.get('frame_size'),
                params.get('sample_aspect_ratio'))
        return self._add_encoding_video_stream(*args, **kw)

    def _add_encoding_video_stream(self, codec, frame_size, frame_rate,
                                   bit_rate=0, options='',
                                   sample_aspect_ratio=None,
                                   interlaced=False, top_field_first=False):
        err = _err_buf()
        from fractions import Fraction
        rate = _as_frame_rate(frame_rate)
        sar_num = sar_den = 0
        if sample_aspect_ratio is not None:
            sar = Fraction(sample_aspect_ratio)
            sar_num, sar_den = sar.numerator, sar.denominator
        idx = _load().cav_muxer_add_video_ex(
            self._handle, codec.encode(), int(frame_size[0]),
            int(frame_size[1]), rate.numerator, rate.denominator,
            int(bit_rate), sar_num, sar_den,
            1 if interlaced else 0, 1 if top_field_first else 0,
            options.encode(), err, len(err))
        if idx < 0:
            raise IOError(err.value.decode())
        self._video_dims[idx] = (int(frame_size[0]), int(frame_size[1]))
        return idx

    def add_audio_stream(self, codec, sample_rate, channels, bit_rate=0):
        err = _err_buf()
        idx = _load().cav_muxer_add_audio(
            self._handle, codec.encode(), int(sample_rate), int(channels),
            int(bit_rate), err, len(err))
        if idx < 0:
            raise IOError(err.value.decode())
        self._audio_channels[idx] = int(channels)
        return idx

    def _add_copy_video_stream(self, source, codec, frame_rate, frame_size,
                               sample_aspect_ratio):
        """Stream-copy video stream (reference AVMuxer model,
        src/libav/AVMuxer.c:144-210): *source* is a CodecPacketSource
        whose packets are already encoded with *codec*."""
        from fractions import Fraction
        if not isinstance(codec, str):
            raise TypeError('codec name must be a string')
        if frame_rate is None or frame_size is None:
            raise TypeError('copy streams require frame_rate and '
                            'frame_size')
        rate = _as_frame_rate(frame_rate)
        sar_num = sar_den = 0
        if sample_aspect_ratio is not None:
            sar = Fraction(sample_aspect_ratio)
            sar_num, sar_den = sar.numerator, sar.denominator
        err = _err_buf()
        idx = _load().cav_muxer_add_copy_video(
            self._handle, codec.encode(), int(frame_size[0]),
            int(frame_size[1]), rate.numerator, rate.denominator,
            sar_num, sar_den, err, len(err))
        if idx < 0:
            raise IOError(err.value.decode())
        self._copy_streams[idx] = {'source': source, 'rate': rate}
        return idx

    def run(self):
        """Pump packets from every copy-stream source into the file and
        finalize it (reference AVMuxer_run, src/libav/AVMuxer.c:212-333):
        fetch each source's global header, write the container header,
        then repeatedly write the packet whose dts maps to the earliest
        real time across streams, until all sources are exhausted."""
        from fractions import Fraction
        if not self._copy_streams:
            raise RuntimeError('run() needs at least one copy stream '
                               '(add_video_stream(source, codec, ...))')
        if self._started:
            # extradata (avcC/SPS-PPS) lands in the container header:
            # applying it after avformat_write_header already ran would
            # silently produce files many players cannot decode
            raise RuntimeError(
                'run() must drive the mux from the start: the container '
                'header was already written (did an encoding stream '
                'auto-start the muxer?), so copy-stream extradata can '
                'no longer be applied')
        lib = _load()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for idx, cs in self._copy_streams.items():
            get_header = getattr(cs['source'], 'get_header', None)
            header = get_header() if get_header else None
            if header:
                buf = (ctypes.c_uint8 * len(header)).from_buffer_copy(header)
                lib.cav_muxer_set_extradata(self._handle, idx,
                                            ctypes.cast(buf, u8p),
                                            len(header))
        self.start()

        NOPTS = -(1 << 63)          # AV_NOPTS_VALUE

        def real_time(idx, pkt):
            dts = pkt.dts if pkt.dts is not None else (pkt.pts or 0)
            return Fraction(dts) / self._copy_streams[idx]['rate']

        pending = {}
        for idx, cs in self._copy_streams.items():
            pkt = cs['source'].get_next_packet()
            if pkt is not None:
                pending[idx] = pkt
        while pending:
            idx = min(pending, key=lambda i: real_time(i, pending[i]))
            pkt = pending[idx]
            data = bytes(pkt.data)
            buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            rc = lib.cav_muxer_write_packet(
                self._handle, idx, ctypes.cast(buf, u8p), len(data),
                NOPTS if pkt.pts is None else int(pkt.pts),
                NOPTS if pkt.dts is None else int(pkt.dts),
                int(pkt.duration or 0), 1 if pkt.keyframe else 0)
            if rc < 0:
                raise IOError('write_packet failed: %d' % rc)
            nxt = self._copy_streams[idx]['source'].get_next_packet()
            if nxt is None:
                del pending[idx]
            else:
                pending[idx] = nxt
        self.close()

    def start(self):
        err = _err_buf()
        rc = _load().cav_muxer_start(self._handle, err, len(err))
        if rc < 0:
            raise IOError(err.value.decode())
        self._started = True

    def write_video_frame(self, stream, rgba):
        """rgba: (H, W, 4) uint8."""
        if not self._started:
            self.start()
        rgba = np.ascontiguousarray(rgba, np.uint8)
        want = self._video_dims.get(int(stream))
        # shape validated HERE: the native layer reads h*w*4 bytes from
        # the raw pointer and cannot know the array's real size
        if want is not None and rgba.shape != (want[1], want[0], 4):
            raise ValueError('frame shape %r does not match stream '
                             'geometry (%d, %d, 4)'
                             % (rgba.shape, want[1], want[0]))
        rc = _load().cav_muxer_write_video(
            self._handle, int(stream),
            rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc < 0:
            raise IOError('write_video failed: %d' % rc)

    def write_video_frame_planar(self, stream, y, cb, cr):
        """Pre-subsampled planar YCbCr 4:2:0 u8 frame: *y* (H, W),
        *cb*/*cr* (ceil(H/2), ceil(W/2)), studio range. Copies straight
        into the codec frame when it consumes yuv420p (no sws pass)."""
        if not self._started:
            self.start()
        y = np.ascontiguousarray(y, np.uint8)
        cb = np.ascontiguousarray(cb, np.uint8)
        cr = np.ascontiguousarray(cr, np.uint8)
        want = self._video_dims.get(int(stream))
        if want is not None:
            w, h = want
            ch, cw = (h + 1) // 2, (w + 1) // 2
            if (y.shape != (h, w) or cb.shape != (ch, cw)
                    or cr.shape != (ch, cw)):
                raise ValueError(
                    'planar frame shapes y%r cb%r cr%r do not match '
                    'stream geometry (%d, %d)/(%d, %d)'
                    % (y.shape, cb.shape, cr.shape, h, w, ch, cw))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = _load().cav_muxer_write_video_planar(
            self._handle, int(stream), y.ctypes.data_as(u8p),
            cb.ctypes.data_as(u8p), cr.ctypes.data_as(u8p))
        if rc < 0:
            raise IOError('write_video_planar failed: %d' % rc)

    def write_audio_frame(self, stream, samples):
        """samples: (N, channels) float32 interleaved."""
        if not self._started:
            self.start()
        samples = np.ascontiguousarray(samples, np.float32)
        want_ch = self._audio_channels.get(int(stream))
        if (want_ch is not None
                and (samples.ndim != 2 or samples.shape[1] != want_ch)):
            raise ValueError('audio samples shape %r does not match '
                             'stream channels %d'
                             % (samples.shape, want_ch))
        rc = _load().cav_muxer_write_audio(
            self._handle, int(stream),
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            samples.shape[0])
        if rc < 0:
            raise IOError('write_audio failed: %d' % rc)

    def close(self):
        if self._handle:
            rc = _load().cav_muxer_finish(self._handle)
            self._handle = None
            if rc < 0:
                raise IOError('finish failed: %d' % rc)

    def __del__(self):
        # every other handle-owning class reclaims in __del__; a
        # dropped muxer additionally leaves the file without a trailer
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def stack_frames(arrays):
    """np.stack(axis=0) via preallocate+assign (``canvas_tpu/render.py``'s
    helper: the assignment loop runs at memory speed where some NumPy
    builds concatenate many medium arrays slowly)."""
    a0 = np.asarray(arrays[0])
    out = np.empty((len(arrays),) + a0.shape, a0.dtype)
    for i, a in enumerate(arrays):
        out[i] = a
    return out


def write_video(filename, video_source, audio_source, start_frame, end_frame,
                frame_size=(720, 480), frame_rate=None, sample_rate=48000,
                channels=2, video_codec='mpeg4', audio_codec=None,
                bit_rate=4_000_000, format='', window=None, use_batch=True,
                progress_callback=None, mesh=None,
                sample_aspect_ratio=None, interlaced=False,
                top_field_first=False, transport='rgba_u8', batch=16,
                device=None):
    """One-call export (src/libav/writeVideo.c:41-120): pull video frames,
    gamma-ramp to 8-bit, encode and mux with optional audio.

    Unlike the reference (frame-at-a-time f16 pulls), the video is rendered
    in batches through ``canvas_tpu_torch.render.RenderPlanner`` on
    *device* (None: the card, and raises without one; ``'cpu'``: the
    kernels' plain versions), with the 8-bit conversion fused into each
    batch's render (``iter_batches(post=...)``), so only u8 is fetched.
    *progress_callback(frames_done)* is called per batch; returning False
    aborts the export (the file is finalized with what was written).
    *mesh* (a ``mesh.Mesh`` with a 'frames' axis) splits each render
    batch frame-parallel over its devices (``iter_batches(mesh=)``; the
    encode stays a host gather, each batch's shards fetched into one
    pinned array); *device* then defaults to the mesh's first device.
    With ``use_batch=False`` the frames are eager pulls under the calling
    thread's backend mode, their torch arms on *device*.

    *transport* picks what crosses the host link per frame:

    * 'rgba_u8' (default, reference parity): interleaved u8 RGBA,
      converted to the codec's pixel format by swscale on the host —
      byte-identical inputs to the reference's writeVideo.c path.
    * 'yuv420': the device matrixes + 2x2-subsamples to studio-range
      BT.601 4:2:0 planes (1.5 bytes/px vs 4 — 2.6x fewer fetch bytes,
      and zero host swscale work when the codec consumes yuv420p,
      which mpeg4/x264/mpeg2 all do). Within swscale rounding of the
      default path on flat regions; chroma siting uses the 2x2 mean
      where swscale applies its own phase filter. Requires the batched
      path (use_batch=True).

    A producer thread renders and fetches batch N+1 while this thread
    encodes batch N (a queue two batches deep between them). The wall
    time splits into ``profiling`` totals: ``export.render`` (the
    producer's render plus fetch), ``export.put_wait`` (the producer
    waiting for room in the queue), ``export.get_wait`` (this thread
    waiting for a batch) and ``export.encode`` (encode and mux, audio
    included).
    """
    from fractions import Fraction

    from canvas_tpu_torch import render

    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError('mesh must be a canvas_tpu_torch.mesh.Mesh, '
                            'not %r' % (mesh,))
        if device is None:
            device = mesh.devices.flat[0]
    device = backend.resolve_device(device)
    # the producer thread pulls under the caller's mode, not its own
    mode = backend.get_backend()
    if frame_rate is None:
        frame_rate = Fraction(30000, 1001)
    # normalize up front: the audio sample math below needs
    # numerator/denominator, which a float frame_rate lacks. Floats
    # must snap to a sane ratio (Fraction(30000/1001) is an exact
    # binary fraction with a ~10^15 denominator avcodec rejects).
    frame_rate = _as_frame_rate(frame_rate)
    if window is None:
        window = box2i(0, 0, frame_size[0] - 1, frame_size[1] - 1)
    elif (window.width, window.height) != tuple(frame_size):
        # the native mux writers stride buffers by the CODEC's
        # frame_size; a mismatched render window would read past each
        # frame's rows (use the window's size as the frame size, or
        # scale in the graph)
        raise ValueError('window %dx%d does not match frame_size %dx%d'
                         % (window.width, window.height,
                            frame_size[0], frame_size[1]))
    if transport not in ('rgba_u8', 'yuv420'):
        raise ValueError('unknown transport: %r' % (transport,))
    if transport == 'yuv420' and not use_batch:
        raise ValueError('transport=yuv420 requires the batched path '
                         '(the 4:2:0 pack runs on device)')

    n_frames = int(end_frame - start_frame)
    with AVMuxer(filename, format) as mux:
        vstream = mux.add_video_stream(
            video_codec, frame_size, frame_rate, bit_rate,
            sample_aspect_ratio=sample_aspect_ratio,
            interlaced=interlaced, top_field_first=top_field_first)
        astream = None
        if audio_source is not None and not audio_codec:
            raise ValueError('audio_source given without audio_codec: '
                             "pass audio_codec (e.g. 'aac') or drop the "
                             'audio source')
        if audio_source is not None:
            astream = mux.add_audio_stream(audio_codec, sample_rate, channels)
        mux.start()

        batch = max(1, int(batch))

        def iter_render():
            """Yield (b0, b1, u8_batch) in frame order. Batched path
            streams through RenderPlanner.iter_batches with the u8
            conversion fused into the render: (B, H, W, 4) RGBA, or for
            transport='yuv420' packed planar 4:2:0
            (B, H*W + 2*ceil(H/2)*ceil(W/2)). The NumPy path pulls
            f16 frames one at a time (under the caller's backend mode)
            and ramps them on the host."""
            if use_batch:
                planner = render.RenderPlanner(video_source, window,
                                               device=device)
                post = 'yuv420' if transport == 'yuv420' else 'rgba_u8'
                batches = planner.iter_batches(
                    start_frame, start_frame + n_frames, batch=batch,
                    device_out=True, mesh=mesh, post=post)
                while True:
                    with profiling.Timer('export.render'):
                        got = next(batches, None)
                        if got is None:
                            return
                        s, n, data = got
                        # the numpy view keeps the pinned host copy
                        # alive until the encoder has read it (a
                        # sharded batch: each shard into its block)
                        flat = backend.to_host(data).numpy()
                    if transport == 'rgba_u8':
                        flat = flat.reshape(flat.shape[0], flat.shape[1],
                                            -1, 4)
                    yield s - start_frame, s - start_frame + n, flat
            else:
                for b0 in range(0, n_frames, batch):
                    b1 = min(b0 + batch, n_frames)
                    with profiling.Timer('export.render'), \
                            backend.force_backend(mode, device):
                        frames = stack_frames(
                            [video_source.get_frame_f16(
                                start_frame + i, window).to_numpy()
                             for i in range(b0, b1)])
                        u8 = np.moveaxis(
                            color_ops.apply_gamma45_u8(frames), 1, -1)
                    yield b0, b1, u8

        import queue as queue_mod

        work = queue_mod.Queue(maxsize=2)
        stop_flag = threading.Event()

        def producer():
            try:
                for b0, b1, rgba in iter_render():
                    if stop_flag.is_set():
                        break
                    with profiling.Timer('export.put_wait'):
                        work.put((b0, b1, rgba, None))
            except Exception as ex:
                work.put((None, None, None, ex))
            finally:
                work.put(None)

        thread = threading.Thread(target=producer, daemon=True,
                                  name='canvas-torch-export-render')
        thread.start()
        try:
            while True:
                with profiling.Timer('export.get_wait'):
                    item = work.get()
                if item is None:
                    break
                b0, b1, rgba, error = item
                if error is not None:
                    raise error
                with profiling.Timer('export.encode'):
                    if transport == 'yuv420':
                        H = window.height
                        W = window.width
                        h2, w2 = (H + 1) // 2, (W + 1) // 2
                        for i in range(rgba.shape[0]):
                            row = rgba[i]
                            mux.write_video_frame_planar(
                                vstream,
                                row[:H * W].reshape(H, W),
                                row[H * W:H * W + h2 * w2].reshape(h2, w2),
                                row[H * W + h2 * w2:].reshape(h2, w2))
                    else:
                        for i in range(rgba.shape[0]):
                            mux.write_video_frame(vstream, rgba[i])

                    if astream is not None:
                        s0 = (start_frame + b0) * sample_rate * \
                            frame_rate.denominator // frame_rate.numerator
                        s1 = (start_frame + b1) * sample_rate * \
                            frame_rate.denominator // frame_rate.numerator
                        aframe = audio_source.get_frame(s0, s1 - 1, channels)
                        mux.write_audio_frame(astream,
                                              np.asarray(aframe.data))

                if progress_callback is not None:
                    if progress_callback(b1) is False:
                        stop_flag.set()
                        break
        finally:
            stop_flag.set()
            # Drain so the producer can exit
            try:
                while work.get_nowait() is not None:
                    pass
            except queue_mod.Empty:
                pass
            thread.join(timeout=10)


# --------------------------------------------------------------------------
# Standalone packet encoders (reference AVVideoEncoder.c shape)

class _EncoderBase:
    def _setup(self):
        lib = _load()
        lib.cav_video_encoder_open.restype = ctypes.c_void_p
        lib.cav_video_encoder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int]
        lib.cav_video_encoder_open_ex.restype = ctypes.c_void_p
        lib.cav_video_encoder_open_ex.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int]
        lib.cav_audio_encoder_open.restype = ctypes.c_void_p
        lib.cav_audio_encoder_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int]
        lib.cav_encoder_close.argtypes = [ctypes.c_void_p]
        lib.cav_encoder_extradata.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.cav_encoder_frame_size.argtypes = [ctypes.c_void_p]
        lib.cav_encoder_send_video.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.cav_encoder_send_audio.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.cav_encoder_flush.argtypes = [ctypes.c_void_p]
        lib.cav_encoder_packet.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(_CavPacket)]
        return lib

    def get_header(self):
        """Codec global header bytes (SPS/PPS / AudioSpecificConfig) —
        reference CodecPacketSource.get_header / X264VideoEncoder sps+pps."""
        lib = _load()
        n = lib.cav_encoder_extradata(self._handle, None, 0)
        if n <= 0:
            return b''
        buf = (ctypes.c_uint8 * n)()
        lib.cav_encoder_extradata(
            self._handle, ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), n)
        return bytes(buf)

    def _next_packet(self):
        lib = _load()
        pkt = _CavPacket()
        rc = lib.cav_encoder_packet(self._handle, ctypes.byref(pkt))
        if rc == 0:
            return None
        if rc < 0:
            raise IOError('encoder packet failed: %d' % rc)
        data = ctypes.string_at(pkt.data, pkt.size)
        lib.cav_packet_free(ctypes.byref(pkt))
        return CodecPacket(data, pkt.pts, pkt.dts, pkt.duration,
                           bool(pkt.keyframe), 0)

    def close(self):
        if getattr(self, '_handle', None):
            _load().cav_encoder_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AVVideoEncoder(_EncoderBase):
    """Video source -> codec packet source (src/libav/AVVideoEncoder.c
    shape; also the X264VideoEncoder role when codec='libx264').

    Pulls frames [start_frame, end_frame] from *source* through the
    batched render on *device* (None: the card; ``'cpu'``: the plain
    versions), gamma-ramped to 8-bit there, and encodes; packets come
    out of get_next_packet() for a muxer (e.g. MatroskaWriter).
    """

    def __init__(self, source, *args, **kw):
        """``AVVideoEncoder(source, start_frame, end_frame,
        codec='libx264', ...)``; the reference's convention with the
        codec name second (``AVVideoEncoder(source, 'dvvideo',
        start_frame=0, end_frame=200, sample_aspect_ratio=...,
        interlaced=..., top_field_first=..., frame_rate=...)``,
        src/libav/AVVideoEncoder.c:41-175) is also accepted."""
        from fractions import Fraction
        if args and isinstance(args[0], str):
            if 'codec' in kw:
                raise TypeError('multiple values for codec')
            kw['codec'] = args[0]
            args = args[1:]
        for name, val in zip(('start_frame', 'end_frame'), args):
            if name in kw:
                raise TypeError('multiple values for %r' % name)
            kw[name] = val
        if len(args) > 2:
            raise TypeError('too many positional arguments')

        start_frame = kw.pop('start_frame')
        end_frame = kw.pop('end_frame')
        codec = kw.pop('codec', 'libx264')
        frame_size = kw.pop('frame_size', (720, 480))
        frame_rate = kw.pop('frame_rate', None)
        bit_rate = kw.pop('bit_rate', 0)
        options = kw.pop('options', '')
        window = kw.pop('window', None)
        sample_aspect_ratio = kw.pop('sample_aspect_ratio', None)
        interlaced = kw.pop('interlaced', False)
        top_field_first = kw.pop('top_field_first', False)
        device = kw.pop('device', None)
        if kw:
            raise TypeError('unexpected kwargs: %s' % ', '.join(sorted(kw)))

        # The reference's AVVideoEncoder/X264VideoEncoder consume CODED
        # IMAGES (AVVideoEncoder.c:64, py_coded_image_take_source) —
        # that role is AVPlanarVideoEncoder here.  A coded-image source
        # (get_frame but no get_frame_f16/f32 pull protocol) delegates
        # to the planar pipeline, so test_packets.py and the encode
        # scripts (e.g. X264VideoEncoder over MPEG2SubsampleFilter)
        # run unchanged; video sources take the batched render path.
        if (hasattr(source, 'get_frame')
                and not hasattr(source, 'get_frame_f16')
                and not hasattr(source, 'get_frame_f32')):
            pix = 'yuv411p' if codec == 'dvvideo' else 'yuv420p'
            self._handle = None
            self._delegate = AVPlanarVideoEncoder(
                source, start_frame, end_frame, codec=codec, pix_fmt=pix,
                frame_size=frame_size, frame_rate=frame_rate,
                bit_rate=bit_rate, options=options,
                sample_aspect_ratio=sample_aspect_ratio,
                interlaced=interlaced, top_field_first=top_field_first)
            self.source = source
            self.start_frame = int(start_frame)
            self.end_frame = int(end_frame)
            self.frame_size = frame_size
            self.frame_rate = self._delegate.frame_rate
            self.window = window
            return
        self._delegate = None
        self.device = backend.resolve_device(device)

        lib = self._setup()
        if frame_rate is None:
            frame_rate = Fraction(30000, 1001)
        frame_rate = _as_frame_rate(frame_rate)
        sar_num = sar_den = 0
        if sample_aspect_ratio is not None:
            sar = Fraction(sample_aspect_ratio)
            sar_num, sar_den = sar.numerator, sar.denominator
        err = _err_buf()
        self._handle = lib.cav_video_encoder_open_ex(
            codec.encode(), int(frame_size[0]), int(frame_size[1]),
            frame_rate.numerator, frame_rate.denominator, int(bit_rate),
            sar_num, sar_den, 1 if interlaced else 0,
            1 if top_field_first else 0, options.encode(), err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())

        self.source = source
        self.start_frame = int(start_frame)
        self.end_frame = int(end_frame)
        self.frame_size = frame_size
        self.frame_rate = frame_rate
        self.window = window or box2i(0, 0, frame_size[0] - 1,
                                      frame_size[1] - 1)
        self._next_to_send = self.start_frame
        self._flushed = False
        self._batch = 8
        self._pending = []
        self._batches = None

    def _send_more(self):
        from canvas_tpu_torch import render
        lib = _load()
        if self._next_to_send > self.end_frame:
            if not self._flushed:
                lib.cav_encoder_flush(self._handle)
                self._flushed = True
            return False
        if self._batches is None:
            planner = render.RenderPlanner(self.source, self.window,
                                           device=self.device)
            self._batches = planner.iter_batches(
                self.start_frame, self.end_frame + 1, batch=self._batch,
                device_out=True, post='rgba_u8')
        try:
            (_s, n, data) = next(self._batches)
        except StopIteration:
            self._next_to_send = self.end_frame + 1
            return self._send_more()
        # gamma ramp and interleave fused into the render; the flat
        # layout fetches in one copy, the host reshape is free
        flat = backend.to_host(data).numpy()
        rgba = flat.reshape(flat.shape[0], flat.shape[1], -1, 4)
        for i in range(n):
            frame_u8 = np.ascontiguousarray(rgba[i])
            while True:
                # Drain between sends: avcodec_send_frame EAGAINs when
                # its output queue fills; on EAGAIN the frame was NOT
                # consumed — drain and resend the SAME frame.
                self._drain()
                rc = lib.cav_encoder_send_video(
                    self._handle,
                    frame_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                if rc == -errno.EAGAIN:    # AVERROR(EAGAIN), platform value
                    continue
                if rc < 0:
                    raise IOError('send_video failed: %d' % rc)
                break
        self._next_to_send = min(self._next_to_send + n,
                                 self.end_frame + 1)
        return True

    def _drain(self):
        while True:
            pkt = self._next_packet()
            if pkt is None:
                return
            self._pending.append(pkt)

    def _pump_next_packet(self):
        while True:
            if self._pending:
                return self._pending.pop(0)
            if not self._send_more() and self._flushed:
                self._drain()
                if self._pending:
                    return self._pending.pop(0)
                return None
            self._drain()

    def get_next_packet(self):
        if self._delegate is not None:
            return self._delegate.get_next_packet()
        return self._pump_next_packet()

    def get_header(self):
        if self._delegate is not None:
            return self._delegate.get_header()
        return _EncoderBase.get_header(self)

    # Reference progress API (AVVideoEncoder.c:243-251): frames done /
    # frames total — the encode scripts' status lines read these.
    @property
    def progress(self):
        if getattr(self, '_delegate', None) is not None:
            return self._delegate.progress
        return min(self._next_to_send, self.end_frame + 1) - self.start_frame

    @property
    def progress_count(self):
        if getattr(self, '_delegate', None) is not None:
            return self._delegate.progress_count
        return self.end_frame - self.start_frame

    def close(self):
        if getattr(self, '_delegate', None) is not None:
            return self._delegate.close()
        _EncoderBase.close(self)


class AVAudioEncoder(_EncoderBase):
    """Audio source -> codec packet source (the AACAudioEncoder role when
    codec='aac'; src/faac/AACAudioEncoder.c:49-270 shape)."""

    def __init__(self, source, start_sample, end_sample, codec='aac',
                 sample_rate=48000, channels=2, bit_rate=0):
        lib = self._setup()
        err = _err_buf()
        self._handle = lib.cav_audio_encoder_open(
            codec.encode(), int(sample_rate), int(channels), int(bit_rate),
            err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())
        self.source = source
        self.start_sample = int(start_sample)
        self.end_sample = int(end_sample)
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self._next_to_send = self.start_sample
        self._flushed = False
        self._pending = []
        # Fixed-frame-size codecs reject short non-final frames, so the
        # pull chunk must be EXACTLY the codec frame size (aac 1024,
        # opus 960) — max(1024, fs) split sub-1024 frames and killed
        # the encode on the second chunk. 0 = variable size: any chunk.
        self._chunk = lib.cav_encoder_frame_size(self._handle) or 1024

    def _send_more(self):
        lib = _load()
        if self._next_to_send > self.end_sample:
            if not self._flushed:
                lib.cav_encoder_flush(self._handle)
                self._flushed = True
            return False
        hi = min(self._next_to_send + self._chunk - 1, self.end_sample)
        frame = self.source.get_frame(self._next_to_send, hi, self.channels)
        data = np.ascontiguousarray(backend.asnumpy(frame.data),
                                    np.float32)
        # cav_encoder_send_audio returns the number of samples consumed;
        # when the codec's output queue backs up (EAGAIN) the tail is
        # unconsumed — drain packets and resend it rather than dropping
        # samples from the encode.
        sent = 0
        while sent < data.shape[0]:
            self._drain()
            rc = lib.cav_encoder_send_audio(
                self._handle,
                data[sent:].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                data.shape[0] - sent)
            if rc < 0:
                raise IOError('send_audio failed: %d' % rc)
            sent += rc
        self._next_to_send = hi + 1
        return True

    _drain = AVVideoEncoder._drain
    get_next_packet = AVVideoEncoder._pump_next_packet

    @property
    def progress(self):
        # samples done / samples total (AACAudioEncoder.c:280-289)
        return (min(self._next_to_send, self.end_sample + 1)
                - self.start_sample)

    @property
    def progress_count(self):
        return self.end_sample - self.start_sample + 1


class AVPlanarVideoEncoder(_EncoderBase):
    """Coded-image source -> codec packet source.

    This is the reference's encoder shape (AVVideoEncoder.c /
    X264VideoEncoder.c consume *coded images*): pre-subsampled planar
    YCbCr frames — e.g. DVSubsampleFilter or MPEG2SubsampleFilter output
    computed on device — go straight into the codec with no RGB round
    trip.
    """

    def __init__(self, source, *args, **kw):
        """``AVPlanarVideoEncoder(source, start_frame, end_frame,
        codec='dvvideo', pix_fmt='yuv411p', ...)``; the reference's
        codec-second convention and its sample_aspect_ratio /
        interlaced / top_field_first kwargs (AVVideoEncoder.c:41-175)
        are also accepted (AVVideoEncoder redirects coded-image
        sources here)."""
        from fractions import Fraction
        if args and isinstance(args[0], str):
            if 'codec' in kw:
                raise TypeError('multiple values for codec')
            kw['codec'] = args[0]
            args = args[1:]
        for name, val in zip(('start_frame', 'end_frame'), args):
            if name in kw:
                raise TypeError('multiple values for %r' % name)
            kw[name] = val
        if len(args) > 2:
            raise TypeError('too many positional arguments')
        start_frame = kw.pop('start_frame')
        end_frame = kw.pop('end_frame')
        codec = kw.pop('codec', 'dvvideo')
        pix_fmt = kw.pop('pix_fmt', 'yuv411p')
        frame_size = kw.pop('frame_size', (720, 480))
        frame_rate = kw.pop('frame_rate', None)
        bit_rate = kw.pop('bit_rate', 0)
        options = kw.pop('options', '')
        sample_aspect_ratio = kw.pop('sample_aspect_ratio', None)
        interlaced = kw.pop('interlaced', False)
        top_field_first = kw.pop('top_field_first', False)
        if kw:
            raise TypeError('unexpected kwargs: %s' % ', '.join(sorted(kw)))

        lib = self._setup()
        lib.cav_video_encoder_open_planar_ex.restype = ctypes.c_void_p
        lib.cav_video_encoder_open_planar_ex.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.cav_encoder_send_planar.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        if frame_rate is None:
            frame_rate = Fraction(30000, 1001)
        frame_rate = _as_frame_rate(frame_rate)
        sar_num = sar_den = 0
        if sample_aspect_ratio is not None:
            sar = Fraction(sample_aspect_ratio)
            sar_num, sar_den = sar.numerator, sar.denominator
        err = _err_buf()
        self._handle = lib.cav_video_encoder_open_planar_ex(
            codec.encode(), pix_fmt.encode(), int(frame_size[0]),
            int(frame_size[1]), frame_rate.numerator,
            frame_rate.denominator, int(bit_rate), sar_num, sar_den,
            1 if interlaced else 0, 1 if top_field_first else 0,
            options.encode(), err, len(err))
        if not self._handle:
            raise IOError(err.value.decode())

        self.source = source
        self.start_frame = int(start_frame)
        self.end_frame = int(end_frame)
        self.frame_rate = frame_rate
        self._next_to_send = self.start_frame
        self._flushed = False
        self._pending = []

    def _send_more(self):
        lib = _load()
        if self._next_to_send > self.end_frame:
            if not self._flushed:
                lib.cav_encoder_flush(self._handle)
                self._flushed = True
            return False
        image = self.source.get_frame(self._next_to_send)
        if image is None:
            self._next_to_send = self.end_frame + 1
            return self._send_more()
        planes = [np.ascontiguousarray(p, np.uint8) for p in image]
        while True:
            self._drain()
            if planes[1].shape != planes[2].shape:
                raise ValueError('cb/cr plane shapes differ: %r vs %r'
                                 % (planes[1].shape, planes[2].shape))
            rc = lib.cav_encoder_send_planar(
                self._handle,
                planes[0].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                planes[0].shape[1], planes[0].shape[0],
                planes[1].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                planes[1].shape[1],
                planes[2].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                planes[2].shape[1], planes[1].shape[0])
            if rc == -errno.EAGAIN:   # AVERROR(EAGAIN): not consumed, resend
                continue
            if rc == -2:
                raise ValueError(
                    'source planes have fewer rows than the encoder '
                    'geometry requires (y %r, chroma %r)'
                    % (planes[0].shape, planes[1].shape))
            if rc < 0:
                raise IOError('send_planar failed: %d' % rc)
            break
        self._next_to_send += 1
        return True

    _drain = AVVideoEncoder._drain
    get_next_packet = AVVideoEncoder._pump_next_packet

    @property
    def progress(self):
        # frames done / frames total (AVVideoEncoder.c:243-251)
        return (min(self._next_to_send, self.end_frame + 1)
                - self.start_frame)

    @property
    def progress_count(self):
        return self.end_frame - self.start_frame
