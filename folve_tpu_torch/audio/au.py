"""Sun/NeXT AU (.au/.snd) — native reader and streaming encoder.

The reference decodes AU through libsndfile's probe (anything sf_open
accepts, convolve-file-handler.cc:62-76) and writes the convolved
output back in the original format ("else: original format",
convolve-file-handler.cc:237-251).  Here both directions are
implemented directly: big-endian header, PCM 8/16/24/32, float32/64,
and mu-law/A-law decode.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from folve_tpu_torch.audio.pcm_stream import PcmStreamEncoderBase
from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class AuError(ValueError):
    pass


_MAGIC = b".snd"
_ENC_BITS = {1: 8, 2: 8, 3: 16, 4: 24, 5: 32, 6: 32, 7: 64, 27: 8}
_ENC_CODEC = {
    1: SampleCodec.PCM_16,  # mu-law decodes to 16-bit range
    2: SampleCodec.PCM_S8,
    3: SampleCodec.PCM_16,
    4: SampleCodec.PCM_24,
    5: SampleCodec.PCM_32,
    6: SampleCodec.FLOAT,
    7: SampleCodec.DOUBLE,
    27: SampleCodec.PCM_16,  # A-law
}
# CCITT G.72x ADPCM encodings: continuous sub-byte code streams with
# continuous predictor state (decoded by native/g72x_codec.cc via a
# stateful source, not the chunked PCM path).  enc -> code bits.
_ENC_G72X = {23: 4, 25: 3, 26: 5}
_G72X_CODEC = {23: SampleCodec.G721_32, 25: SampleCodec.G723_24,
               26: SampleCodec.G723_40}


def _mulaw_table() -> np.ndarray:
    u = np.arange(256, dtype=np.int32) ^ 0xFF
    sign = np.where(u & 0x80, -1, 1)
    exponent = (u >> 4) & 7
    mantissa = u & 0x0F
    magnitude = ((mantissa << 3) + 0x84 << exponent) - 0x84
    return (sign * magnitude).astype(np.int16)


def _alaw_table() -> np.ndarray:
    a = np.arange(256, dtype=np.int32) ^ 0x55
    # G.711 A-law: MSB 1 = POSITIVE (opposite of mu-law's convention).
    sign = np.where(a & 0x80, 1, -1)
    exponent = (a >> 4) & 7
    mantissa = a & 0x0F
    mag = np.where(
        exponent == 0, (mantissa << 4) + 8, ((mantissa << 4) + 0x108) << (exponent - 1)
    )
    return (sign * mag).astype(np.int16)


def _parse_header(blob: bytes):
    if len(blob) < 24 or blob[:4] != _MAGIC:
        raise AuError("not an AU file")
    offset, size, enc, rate, channels = struct.unpack(">IIIII", blob[4:24])
    if enc not in _ENC_BITS and enc not in _ENC_G72X:
        raise AuError(f"unsupported AU encoding {enc}")
    if channels == 0 or rate == 0 or offset < 24:
        raise AuError("bad AU header")
    avail = max(0, len(blob) - offset)
    if size == 0xFFFFFFFF or size > avail:
        size = avail  # unknown/overstated length: till EOF
    if enc in _ENC_G72X:
        frames = size * 8 // _ENC_G72X[enc]
    else:
        bits = _ENC_BITS[enc]
        frames = size // (channels * (bits // 8))
    return offset, size, enc, rate, channels, frames


def read_au_info(path: str) -> AudioInfo:
    f, src_or_info, _off, _fb, _dec = open_au_stream(path)
    if f is None:  # G.72x: ready-made source in slot 1
        info = src_or_info.info
        src_or_info.close()
        return info
    f.close()
    return src_or_info


def _decode_payload(raw: bytes, enc: int, channels: int) -> np.ndarray:
    """Raw AU payload bytes (any whole-frame slice) -> float32 [n, ch].
    Truncated payloads short-decode (like the WAV/AIFF readers) instead
    of raising from np.frombuffer on a partial trailing sample."""
    elem = _ENC_BITS[enc] // 8
    raw = raw[: (len(raw) // elem) * elem]
    if enc == 1:
        data = _mulaw_table()[np.frombuffer(raw, np.uint8)] / 32768.0
    elif enc == 27:
        data = _alaw_table()[np.frombuffer(raw, np.uint8)] / 32768.0
    elif enc == 2:
        data = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    elif enc == 3:
        data = np.frombuffer(raw, ">i2").astype(np.float32) / 32768.0
    elif enc == 4:
        b = np.frombuffer(raw[: (len(raw) // 3) * 3], np.uint8).reshape(-1, 3)
        v = (
            (b[:, 0].astype(np.int32) << 16)
            | (b[:, 1].astype(np.int32) << 8)
            | b[:, 2]
        )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        data = v.astype(np.float32) / float(1 << 23)
    elif enc == 5:
        data = np.frombuffer(raw, ">i4").astype(np.float64) / float(1 << 31)
    elif enc == 6:
        data = np.frombuffer(raw, ">f4").astype(np.float64)
    else:  # 7
        data = np.frombuffer(raw, ">f8")
    data = np.asarray(data, np.float32)
    n = data.size // channels
    return data[: n * channels].reshape(n, channels)


def read_au(path: str) -> tuple[np.ndarray, AudioInfo]:
    with open(path, "rb") as f:
        blob = f.read()
    offset, size, enc, rate, channels, frames = _parse_header(blob)
    if enc in _ENC_G72X:
        from folve_tpu_torch.audio.g72x import decode_g72x

        if channels != 1:
            raise AuError("G.72x is mono-only")
        data = decode_g72x(blob[offset : offset + size], _ENC_G72X[enc])
        info = AudioInfo(
            rate=rate, channels=1, frames=data.shape[0],
            container=Container.AU, codec=_G72X_CODEC[enc],
            bits_per_sample=16,
        )
        return data, info
    data = _decode_payload(blob[offset : offset + size], enc, channels)
    info = AudioInfo(
        rate=rate, channels=channels, frames=data.shape[0],
        container=Container.AU, codec=_ENC_CODEC[enc],
        bits_per_sample=16 if enc in (1, 27) else _ENC_BITS[enc],
    )
    return data, info


def open_au_stream(path: str):
    """(file, info, data_offset, frame_bytes, decode) for a chunked
    source.  frame_bytes uses the STORAGE width (mu-law/A-law store one
    byte per sample but report 16-bit depth)."""
    f = open(path, "rb")
    try:
        hdr = f.read(24)
        f.seek(0, 2)
        total = f.tell()
        if len(hdr) < 24 or hdr[:4] != _MAGIC:
            raise AuError("not an AU file")
        offset, size, enc, rate, channels = struct.unpack(">IIIII", hdr[4:24])
        if (enc not in _ENC_BITS and enc not in _ENC_G72X) or \
                channels == 0 or rate == 0 or offset < 24:
            raise AuError("bad AU header")
        avail = max(0, total - offset)
        if size == 0xFFFFFFFF or size > avail:
            size = avail
        if enc in _ENC_G72X:
            from folve_tpu_torch.audio.g72x import G72xSource

            if channels != 1:
                raise AuError("G.72x is mono-only")
            bits_code = _ENC_G72X[enc]
            info = AudioInfo(
                rate=rate, channels=1, frames=size * 8 // bits_code,
                container=Container.AU, codec=_G72X_CODEC[enc],
                bits_per_sample=16,
            )
            return None, G72xSource(f, info, offset, size, bits_code), \
                offset, 0, None
        bits = _ENC_BITS[enc]
        frames = size // (channels * (bits // 8))
        info = AudioInfo(
            rate=rate, channels=channels, frames=frames,
            container=Container.AU, codec=_ENC_CODEC[enc],
            bits_per_sample=16 if enc in (1, 27) else bits,
        )
    except Exception:
        f.close()
        raise
    frame_bytes = channels * (bits // 8)
    return f, info, offset, frame_bytes, (
        lambda raw: _decode_payload(raw, enc, channels)
    )


class AuStreamEncoder(PcmStreamEncoderBase):
    """Streaming AU encoder: raw big-endian PCM behind an exact-size
    header."""

    _error = AuError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        # AU has a free-text annotation field; carry tags as key=value
        # lines (no standard structured tags exist for AU).
        ann = b""
        for k, v in (metadata or {}).items():
            ann += f"{k}={v}\n".encode()
        if not ann:
            # The Sun spec's annotation field is minimum 4 bytes (the
            # canonical minimal header is 28 bytes); strict readers
            # reject offset 24.
            ann = b"\0" * 4
        if len(ann) % 8:
            ann += b"\0" * (8 - len(ann) % 8)
        size = self.total_frames * self.channels * self.bits // 8
        enc = 3 if self.bits == 16 else 4
        return (
            _MAGIC
            + struct.pack(">IIIII", 24 + len(ann), size, enc, self.rate,
                          self.channels)
            + ann
        )


def write_au(dst, data: np.ndarray, rate: int, bits: int = 16) -> None:
    """Encode float32 [frames, ch] as big-endian PCM AU."""
    if data.ndim == 1:
        data = data[:, None]
    enc = AuStreamEncoder(rate, data.shape[1], bits, data.shape[0])
    blob = enc.header() + enc.write_float(data)
    if hasattr(dst, "write"):
        dst.write(blob)
    else:
        with open(dst, "wb") as f:
            f.write(blob)
