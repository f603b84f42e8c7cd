"""Sony Wave64 (.w64) — native reader and streaming encoder.

Wave64 is WAV with 16-byte GUID chunk ids and 64-bit sizes (the RIFF
4 GiB limit removed); the fmt/data payloads are byte-identical to
WAV's.  The reference consumes it through libsndfile's probe
(convolve-file-handler.cc:62-76) and writes the original format back.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from folve_tpu_torch.audio.pcm_stream import PcmStreamEncoderBase
from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class W64Error(ValueError):
    pass


_TAIL = bytes([0xF3, 0xAC, 0xD3, 0x11, 0x8C, 0xD1, 0x00, 0xC0, 0x4F, 0x8E,
               0xDB, 0x8A])
GUID_RIFF = b"riff" + bytes([0x2E, 0x91, 0xCF, 0x11, 0xA5, 0xD6, 0x28, 0xDB,
                             0x04, 0xC1, 0x00, 0x00])
GUID_WAVE = b"wave" + _TAIL
GUID_FMT = b"fmt " + _TAIL
GUID_DATA = b"data" + _TAIL

WAVE_FORMAT_PCM = 1  # tag interpretation lives in wav.interpret_fmt


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _parse(blob: bytes):
    if len(blob) < 40 or blob[:16] != GUID_RIFF or blob[24:40] != GUID_WAVE:
        raise W64Error("not a Wave64 file")
    pos = 40
    fmt = None
    data_off = data_len = None
    while pos + 24 <= len(blob):
        guid = blob[pos : pos + 16]
        # Chunk size INCLUDES the 24-byte chunk header (Wave64 quirk).
        (size,) = struct.unpack("<Q", blob[pos + 16 : pos + 24])
        if size < 24:
            raise W64Error("bad chunk size")
        body = blob[pos + 24 : pos + size]
        if guid == GUID_FMT:
            fmt = body
        elif guid == GUID_DATA:
            data_off, data_len = pos + 24, min(size - 24, len(blob) - pos - 24)
        pos += _align8(size)
    if fmt is None or data_off is None:
        raise W64Error("missing fmt/data chunks")
    return fmt, data_off, data_len


def _interpret(fmt: bytes, data_len: int) -> AudioInfo:
    """fmt payload -> AudioInfo via the shared WAV fmt interpreter —
    Wave64 carries a byte-identical WAVEFORMAT(EX) chunk, so every WAV
    sample codec (PCM/float/G.711/IMA/MS-ADPCM/GSM/G.721) decodes here
    too, like libsndfile's shared wav_w64 parser gives the reference."""
    from folve_tpu_torch.audio.wav import WavError, interpret_fmt

    try:
        return interpret_fmt(fmt, data_len, None, Container.W64,
                             allow_mpeg=False)
    except WavError as e:
        raise W64Error(str(e)) from None


def read_w64(path: str) -> tuple[np.ndarray, AudioInfo]:
    with open(path, "rb") as f:
        blob = f.read()
    fmt, off, length = _parse(blob)
    info = _interpret(fmt, int(length))
    from folve_tpu_torch.audio.wav import _decode_pcm

    return _decode_pcm(blob[off : off + length], info), info


def open_w64_stream(path: str):
    """Ready-made streaming AudioSource for a Wave64 file — only the
    chunk directory is read up front, so a multi-GB Wave64 costs
    constant memory per open stream.  PCM/float/G.711/ADPCM go through
    the shared WavSource; GSM/G.721 use their stateful sources."""
    f = open(path, "rb")
    try:
        blob = f.read(1 << 16)
        f.seek(0, 2)
        total = f.tell()
        if len(blob) < 40 or blob[:16] != GUID_RIFF or blob[24:40] != GUID_WAVE:
            raise W64Error("not a Wave64 file")
        pos = 40
        fmt = None
        data_off = data_len = None
        while pos + 24 <= len(blob):
            guid = blob[pos : pos + 16]
            (size,) = struct.unpack("<Q", blob[pos + 16 : pos + 24])
            if size < 24:
                raise W64Error("bad chunk size")
            if guid == GUID_FMT:
                fmt = blob[pos + 24 : pos + size]
            elif guid == GUID_DATA:
                data_off = pos + 24
                data_len = min(size - 24, total - pos - 24)
            pos += _align8(size)
            if fmt is not None and data_len is not None:
                break
        if fmt is None or data_off is None:
            raise W64Error("missing fmt/data chunks")
        info = _interpret(fmt, int(data_len))
        if info.codec == SampleCodec.GSM610:
            # Decoder state is continuous across coded blocks — needs
            # the stateful forward-streaming source.
            from folve_tpu_torch.audio.gsm import GsmSource

            src = GsmSource(f, info, data_off, int(data_len), wav49=True)
        elif info.codec == SampleCodec.G721_32:
            from folve_tpu_torch.audio.g72x import G721_32_BITS, G72xSource

            src = G72xSource(f, info, data_off, int(data_len), G721_32_BITS)
        elif info.codec in (SampleCodec.NMS_16, SampleCodec.NMS_24,
                            SampleCodec.NMS_32):
            from folve_tpu_torch.audio.nms import NmsSource, type_for_codec

            src = NmsSource(f, info, data_off, int(data_len),
                            type_for_codec(info.codec))
        else:
            # Everything else (PCM/float/G.711/IMA/MS-ADPCM) reads
            # through the WAV source logic — frame-granular for sample
            # codecs, covering-block reads for the ADPCMs.
            from folve_tpu_torch.audio.source import WavSource

            src = WavSource(f, parsed=(info, data_off, int(data_len)))
        return src
    except Exception:
        f.close()
        raise


def read_w64_info(path: str) -> AudioInfo:
    src = open_w64_stream(path)
    info = src.info
    src.close()
    return info


class W64StreamEncoder(PcmStreamEncoderBase):
    """Streaming Wave64 encoder: little-endian PCM behind an exact-size
    header."""

    _little_endian = True
    _error = W64Error

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata  # W64 has no standard tag chunk
        payload = self.total_frames * self.channels * self.bits // 8
        balign = self.channels * self.bits // 8
        fmt = struct.pack(
            "<HHIIHH", WAVE_FORMAT_PCM, self.channels, self.rate,
            self.rate * balign, balign, self.bits,
        )
        fmt_chunk = GUID_FMT + struct.pack("<Q", 24 + len(fmt)) + fmt
        fmt_chunk += b"\0" * (_align8(len(fmt_chunk)) - len(fmt_chunk))
        data_hdr = GUID_DATA + struct.pack("<Q", 24 + payload)
        total = 40 + len(fmt_chunk) + len(data_hdr) + payload
        return (
            GUID_RIFF + struct.pack("<Q", total) + GUID_WAVE
            + fmt_chunk + data_hdr
        )


def write_w64(dst, data: np.ndarray, rate: int, bits: int = 16) -> None:
    """Encode float32 [frames, ch] as little-endian PCM Wave64."""
    if data.ndim == 1:
        data = data[:, None]
    enc = W64StreamEncoder(rate, data.shape[1], bits, data.shape[0])
    blob = enc.header() + enc.write_float(data)
    if hasattr(dst, "write"):
        dst.write(blob)
    else:
        with open(dst, "wb") as f:
            f.write(blob)
