"""H.264 encoding module.

API-parity equivalent of the reference's x264 module
(src/x264/X264VideoEncoder.c), implemented over the
native canvas_av packet encoder with the libx264 codec (the same encoder
library the reference links directly). Differences:

* The reference encodes *coded image* (pre-subsampled) input; ours takes
  a video source and renders it through the batched device path, handing
  RGBA to libx264's own colorspace conversion (swscale).
* ``sps``/``pps``/``sei`` are parsed out of the codec's global header
  (avcC/Annex-B extradata) rather than x264_encoder_headers.
"""

from fractions import Fraction

from canvas_tpu_torch import libav

__all__ = ['X264EncoderParams', 'X264VideoEncoder']


class X264EncoderParams:
    """Encoder settings (X264VideoEncoder.c:41-138). Maps onto x264's
    preset/tune system plus rate control, carried through avcodec's
    libx264 wrapper as AVOptions (native layer parses the option
    string with av_dict_parse_string and hands it to avcodec_open2).

    Full parameter audit vs the reference kwlist
    (X264VideoEncoder.c:42-44), see PARITY.md §2.3:

    - preset/tune/width/height/frame_rate/constant_ratefactor/
      constant_quantizer/bitrate/sample_aspect_ratio/interlaced — 1:1.
    - vbv_max_bitrate — reference sets rc.i_vbv_max_bitrate (kbit/s);
      mapped to avcodec's generic ``maxrate``/``bufsize`` (bits/s).
    - timebase — the reference overrides i_timebase for VFR-style
      containers; our packet timestamps always run in frame_rate ticks
      (b_vfr_input = 0 there too), so the value is accepted for API
      parity and recorded, with no encoder-level effect.
    - annex_b / repeat_headers — the reference toggles raw-bitstream
      framing on the encoder; avcodec's wrapper derives framing from
      the consumer (global-header extradata for containers, Annex B
      for raw streams), so these are accepted and recorded but framing
      follows the packet consumer. ``sps``/``pps``/``sei`` parse from
      either form (_split_nals).
    - VUI constants — the reference pins studio-range Rec.709 + MPEG-2
      chroma siting (X264VideoEncoder.c:131-137); mapped to the
      generic color AVOptions below. (overscan/videoformat have no
      avcodec equivalent; recorded in PARITY.md.)
    """

    def __init__(self, preset='medium', tune=None, frame_rate=None,
                 sample_aspect_ratio=None, timebase=None, width=720,
                 height=480, constant_ratefactor=None,
                 constant_quantizer=None, bitrate=None,
                 vbv_max_bitrate=None, annex_b=None, repeat_headers=None,
                 interlaced=False):
        self.preset = preset
        self.tune = tune
        self.frame_rate = Fraction(frame_rate) if frame_rate else \
            Fraction(30000, 1001)
        self.sample_aspect_ratio = sample_aspect_ratio
        self.timebase = timebase
        self.width = int(width)
        self.height = int(height)
        self.constant_ratefactor = constant_ratefactor
        self.constant_quantizer = constant_quantizer
        self.bitrate = bitrate
        self.vbv_max_bitrate = vbv_max_bitrate
        self.annex_b = annex_b
        self.repeat_headers = repeat_headers
        self.interlaced = bool(interlaced)
        self.profile = None
        self.fast_first_pass = False

    def apply_profile(self, profile):
        """Limit settings to *profile* (reference
        X264EncoderParams.apply_profile -> x264_param_apply_profile);
        maps to libx264's ``profile`` AVOption."""
        self.profile = profile

    def apply_fast_first_pass(self):
        """Faster settings for a 2-pass first pass (reference
        X264EncoderParams.apply_fast_first_pass ->
        x264_param_apply_fastfirstpass); maps to libx264's
        ``fastfirstpass`` AVOption (applied by the wrapper during
        pass 1)."""
        self.fast_first_pass = True

    def to_options(self):
        opts = ['preset=%s' % self.preset]
        if self.tune:
            opts.append('tune=%s' % self.tune)
        if self.profile:
            opts.append('profile=%s' % self.profile)
        if self.fast_first_pass:
            opts.append('fastfirstpass=1')
        if self.constant_ratefactor is not None:
            opts.append('crf=%g' % self.constant_ratefactor)
        if self.constant_quantizer is not None:
            opts.append('qp=%d' % self.constant_quantizer)
        if self.vbv_max_bitrate and self.vbv_max_bitrate > 0:
            # the reference passes -1 for "unset"
            # (scripts/encode-video.py: vbv_max_bitrate=(max or -1))
            # x264's unit is kbit/s (x264_param_t.rc.i_vbv_max_bitrate;
            # scripts/encode_video.py documents --max-bitrate KBPS).
            # avcodec's generic maxrate/bufsize AVOptions take BITS/s —
            # the earlier 'vbv-maxrate' spelling was an x264-CLI name
            # avcodec_open2 silently dropped (round-4 audit fix).
            bps = int(self.vbv_max_bitrate) * 1000
            opts.append('maxrate=%d' % bps)
            opts.append('bufsize=%d' % bps)
        if self.sample_aspect_ratio:
            sar = self.sample_aspect_ratio
            if hasattr(sar, 'numerator'):
                opts.append('sar=%d/%d' % (sar.numerator, sar.denominator))
            else:
                # a '10:11'-style string would split on the ':' option
                # separator and corrupt the dict — normalize to '/'
                opts.append('sar=%s' % str(sar).replace(':', '/'))
        if self.interlaced:
            opts.append('flags=+ildct+ilme')
        # Reference VUI pins (X264VideoEncoder.c:131-137): studio-range
        # Rec.709, MPEG-2 ('left') chroma siting.
        opts.append('color_primaries=bt709')
        opts.append('color_trc=bt709')
        opts.append('colorspace=bt709')
        opts.append('color_range=tv')
        opts.append('chroma_sample_location=left')
        return ':'.join(opts)


def _annexb_to_length_prefixed(data):
    """Convert an Annex-B NAL stream (3- or 4-byte start codes) to
    4-byte-length-prefixed NALs (the x264 b_annexb=0 output the
    reference's AVCC-muxing scripts expect — avcodec's libx264 wrapper
    always emits Annex B, so annex_b=False converts here)."""
    out = bytearray()
    i = 0
    n = len(data)
    starts = []
    while i < n - 2:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append((i, i + 3))
                i += 3
                continue
            if i < n - 3 and data[i + 2] == 0 and data[i + 3] == 1:
                starts.append((i, i + 4))
                i += 4
                continue
        i += 1
    if not starts:
        return bytes(data)
    for idx, (s, payload) in enumerate(starts):
        end = starts[idx + 1][0] if idx + 1 < len(starts) else n
        nal = data[payload:end]
        out += len(nal).to_bytes(4, 'big')
        out += nal
    return bytes(out)


def _split_nals(extradata):
    """Split avcC or Annex-B extradata into (sps, pps, sei)."""
    sps = pps = sei = b''
    if not extradata:
        return sps, pps, sei
    if extradata[0] == 1:
        # avcC: [version profile compat level 0xFF] [0xE0|n] (len sps)...
        pos = 5
        n_sps = extradata[pos] & 0x1F
        pos += 1
        for _ in range(n_sps):
            ln = int.from_bytes(extradata[pos:pos + 2], 'big')
            pos += 2
            sps = extradata[pos:pos + ln]
            pos += ln
        n_pps = extradata[pos]
        pos += 1
        for _ in range(n_pps):
            ln = int.from_bytes(extradata[pos:pos + 2], 'big')
            pos += 2
            pps = extradata[pos:pos + ln]
            pos += ln
    else:
        # Annex B: split on start codes
        parts = extradata.split(b'\x00\x00\x01')
        for part in parts:
            if not part:
                continue
            part = part.lstrip(b'\x00')
            if not part:
                continue
            # 4-byte start codes leave the NEXT code's leading zero on
            # this part's tail; a NAL payload never ends in 0x00 (RBSP
            # trailing-bit rule), so stripping is lossless
            part = part.rstrip(b'\x00')
            if not part:
                continue
            nal_type = part[0] & 0x1F
            if nal_type == 7:
                sps = part
            elif nal_type == 8:
                pps = part
            elif nal_type == 6:
                sei = part
    return sps, pps, sei


class X264VideoEncoder(libav.AVVideoEncoder):
    """H.264 packet source over a video source
    (X264VideoEncoder.c:207-388): get_next_packet() + sps/pps/sei."""

    def __init__(self, source, start_frame, end_frame, params=None,
                 window=None, device=None):
        params = params or X264EncoderParams()
        libav.AVVideoEncoder.__init__(
            self, source, start_frame, end_frame, codec='libx264',
            frame_size=(params.width, params.height),
            frame_rate=params.frame_rate,
            bit_rate=(params.bitrate or 0) * 1000 if params.bitrate else 0,
            options=params.to_options(), window=window, device=device)
        self.params = params
        self._headers = None

    def get_next_packet(self):
        pkt = libav.AVVideoEncoder.get_next_packet(self)
        if pkt is not None and self.params.annex_b is False:
            pkt.data = _annexb_to_length_prefixed(pkt.data)
        return pkt

    def _parse_headers(self):
        if self._headers is None:
            self._headers = _split_nals(self.get_header())
        return self._headers

    def _prefixed(self, nal):
        """The reference's sps/pps/sei carry the 4-byte x264 NAL prefix
        (X264VideoEncoder.c exposes x264_encoder_headers' payloads:
        a 4-byte length with annex_b=False, the 00 00 00 01 start code
        otherwise) — its encode scripts slice it off with ``[4:]``
        (scripts/encode_x264_mkv.py:55-56), so the prefix must be
        there for them to run unchanged."""
        if not nal:
            return nal
        if self.params.annex_b:
            return b'\x00\x00\x00\x01' + nal
        return len(nal).to_bytes(4, 'big') + nal

    @property
    def sps(self):
        return self._prefixed(self._parse_headers()[0])

    @property
    def pps(self):
        return self._prefixed(self._parse_headers()[1])

    @property
    def sei(self):
        return self._prefixed(self._parse_headers()[2])
