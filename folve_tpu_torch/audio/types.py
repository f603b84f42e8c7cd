"""Audio stream metadata shared across codecs and the runtime.

Mirrors the role of libsndfile's ``SF_INFO`` (used throughout the
reference, e.g. convolve-file-handler.cc:62-76) with an explicit
container/codec split instead of libsndfile's packed format word.
"""

from __future__ import annotations

import dataclasses
import enum


class Container(enum.Enum):
    WAV = "wav"
    FLAC = "flac"
    OGG = "ogg"
    AIFF = "aiff"
    AU = "au"
    W64 = "w64"
    CAF = "caf"
    MP3 = "mp3"
    VOC = "voc"
    IRCAM = "ircam"
    NIST = "nist"
    SVX = "svx"
    PVF = "pvf"
    PAF = "paf"
    AVR = "avr"
    WVE = "wve"
    MAT = "mat"
    HTK = "htk"
    SDS = "sds"
    MPC = "mpc"
    SD2 = "sd2"
    XI = "xi"
    RAW = "raw"


class SampleCodec(enum.Enum):
    PCM_S8 = "pcm_s8"
    PCM_16 = "pcm_16"
    PCM_24 = "pcm_24"
    PCM_32 = "pcm_32"
    PCM_U8 = "pcm_u8"
    FLOAT = "float"
    DOUBLE = "double"
    FLAC = "flac"
    VORBIS = "vorbis"
    ALAW = "alaw"
    ULAW = "ulaw"
    IMA_ADPCM = "ima_adpcm"
    MS_ADPCM = "ms_adpcm"
    MP3 = "mp3"
    DPCM_8 = "dpcm_8"
    DPCM_16 = "dpcm_16"
    GSM610 = "gsm610"
    ALAC = "alac"
    G721_32 = "g721_32"  # CCITT G.721 ADPCM, 32 kbps (4-bit codes)
    G723_24 = "g723_24"  # CCITT G.723 ADPCM, 24 kbps (3-bit codes)
    G723_40 = "g723_40"  # CCITT G.723 ADPCM, 40 kbps (5-bit codes)
    NMS_16 = "nms_16"    # NMS VBX ADPCM, 16 kbps (2-bit codes)
    NMS_24 = "nms_24"    # NMS VBX ADPCM, 24 kbps (3-bit codes)
    NMS_32 = "nms_32"    # NMS VBX ADPCM, 32 kbps (4-bit codes)
    OPUS = "opus"       # Ogg Opus (CELT-mode; decodes at 48 kHz)
    DWVW = "dwvw"        # TX16W Delta Word Variable Width (12/16/24-bit)


_BITS = {
    SampleCodec.PCM_S8: 8,
    SampleCodec.PCM_U8: 8,
    SampleCodec.PCM_16: 16,
    SampleCodec.PCM_24: 24,
    SampleCodec.PCM_32: 32,
    SampleCodec.FLOAT: 32,
    SampleCodec.DOUBLE: 64,
    SampleCodec.ALAW: 8,
    SampleCodec.ULAW: 8,
    SampleCodec.IMA_ADPCM: 4,
    SampleCodec.MS_ADPCM: 4,
    SampleCodec.MP3: 16,
    SampleCodec.DPCM_8: 8,
    SampleCodec.DPCM_16: 16,
    SampleCodec.GSM610: 16,
    SampleCodec.ALAC: 16,
    SampleCodec.G721_32: 16,
    SampleCodec.G723_24: 16,
    SampleCodec.G723_40: 16,
    SampleCodec.NMS_16: 16,
    SampleCodec.NMS_24: 16,
    SampleCodec.NMS_32: 16,
    SampleCodec.OPUS: 16,
    SampleCodec.DWVW: 16,  # declared depth (12/16/24) comes from COMM
}


@dataclasses.dataclass
class AudioInfo:
    """Shape of a decoded audio stream."""

    rate: int
    channels: int
    frames: int
    container: Container
    codec: SampleCodec
    bits_per_sample: int = 0
    # Block-coded codecs only (IMA/MS ADPCM): bytes per coded block and
    # decoded frames per block.  0 for sample-coded streams.
    block_align: int = 0
    samples_per_block: int = 0
    # Extra per-file codec parameters (MS ADPCM coefficient pairs).
    codec_params: tuple = ()
    # WAVEX ambisonic B-format marking (reference: TYPE_AMB via
    # SFC_WAVEX_GET_AMBISONIC, zita-audiofile.cc:72-73).
    ambisonic: bool = False

    def __post_init__(self):
        if not self.bits_per_sample:
            self.bits_per_sample = _BITS.get(self.codec, 16)

    @property
    def duration_seconds(self) -> float:
        return self.frames / self.rate if self.rate else 0.0

    def format_string(self) -> str:
        """Human-readable like the status page's format column
        (reference: HandlerStats::format, convolve-file-handler.cc:230)."""
        return f"{self.container.value}:{self.rate}/{self.channels}/{self.bits_per_sample}"
