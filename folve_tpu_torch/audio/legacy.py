"""Legacy PCM containers: VOC, IRCAM (.sf), NIST SPHERE, 8SVX/16SV, PVF.

The reference convolves anything libsndfile decodes (probe at
convolve-file-handler.cc:62-76), which includes this long tail of
historical formats.  They are all thin headers over contiguous PCM, so
each gets a parser + (where the format supports our stereo output) a
streaming encoder so convolved files keep their original container
("else: original format", convolve-file-handler.cc:249-251).
8SVX/16SV is effectively mono-only; its convolved output falls back to
FLAC via the handler's default.  Validated sample-exact against
libsndfile-written files (tests/test_legacy_formats.py).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from folve_tpu_torch.audio.pcm_stream import PcmStreamEncoderBase
from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class LegacyError(ValueError):
    pass


def _pcm_decode(raw: bytes, codec: SampleCodec, little: bool) -> np.ndarray:
    if codec == SampleCodec.PCM_16:
        raw = raw[: len(raw) - len(raw) % 2]
        return np.frombuffer(raw, "<i2" if little else ">i2").astype(
            np.float32) / 32768.0
    if codec == SampleCodec.PCM_U8:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if codec == SampleCodec.PCM_S8:
        return np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    if codec == SampleCodec.PCM_24:
        raw = raw[: len(raw) - len(raw) % 3]
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = ((b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]) if not little else (
            (b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0])
        v = (v ^ 0x800000) - 0x800000  # sign-extend 24 bits
        return v.astype(np.float32) / 8388608.0
    if codec == SampleCodec.PCM_32:
        raw = raw[: len(raw) - len(raw) % 4]
        return np.frombuffer(raw, "<i4" if little else ">i4").astype(
            np.float32) / 2147483648.0
    if codec == SampleCodec.FLOAT:
        raw = raw[: len(raw) - len(raw) % 4]
        return np.frombuffer(raw, "<f4" if little else ">f4").astype(np.float32)
    if codec == SampleCodec.ULAW:
        from folve_tpu_torch.audio.au import _mulaw_table

        return _mulaw_table()[np.frombuffer(raw, np.uint8)].astype(
            np.float32) / 32768.0
    if codec == SampleCodec.ALAW:
        from folve_tpu_torch.audio.au import _alaw_table

        return _alaw_table()[np.frombuffer(raw, np.uint8)].astype(
            np.float32) / 32768.0
    raise LegacyError(f"cannot decode {codec}")


_STORAGE = {
    SampleCodec.PCM_16: 2, SampleCodec.PCM_U8: 1, SampleCodec.PCM_S8: 1,
    SampleCodec.FLOAT: 4, SampleCodec.ULAW: 1, SampleCodec.ALAW: 1,
    SampleCodec.PCM_24: 3, SampleCodec.PCM_32: 4,
}


def _make_stream(path, info, offset, little):
    """(file, info, data_offset, frame_bytes, decode) for PcmChunkSource."""
    ch = info.channels
    codec = info.codec
    f = open(path, "rb")
    frame_bytes = _STORAGE[codec] * ch

    def decode(raw):
        x = _pcm_decode(raw, codec, little)
        n = x.size // ch
        return x[: n * ch].reshape(n, ch)

    return f, info, offset, frame_bytes, decode


# ---------------------------------------------------------------------------
# VOC (Creative Voice File)
# ---------------------------------------------------------------------------

_VOC_MAGIC = b"Creative Voice File\x1a"


def _walk_voc(f):
    """Seek-based block walk reading only block headers.
    -> (info, [(offset, size)] data extents, little_endian)."""
    f.seek(0)
    head = f.read(26)
    if len(head) < 26 or head[:20] != _VOC_MAGIC:
        raise LegacyError("not a VOC file")
    (hdr_size,) = struct.unpack("<H", head[20:22])
    f.seek(0, 2)
    total = f.tell()
    pos = hdr_size
    rate = channels = bits = None
    codec = None
    extents = []
    ext_rate = None  # from a type-8 extension block
    while pos + 1 <= total:
        f.seek(pos)
        hdr = f.read(4)
        if not hdr or hdr[0] == 0:  # terminator / EOF
            break
        if len(hdr) < 4:
            raise LegacyError("truncated VOC block header")
        btype = hdr[0]
        size = int.from_bytes(hdr[1:4], "little")
        body = pos + 4
        if body + size > total:
            size = max(0, total - body)
        if btype == 1:  # sound data: sr code, codec byte
            sub = f.read(2)
            if len(sub) < 2 or size < 2:
                raise LegacyError("truncated VOC sound block")
            if rate is None:
                rate = ext_rate or int(round(1000000.0 / (256 - sub[0])))
                channels = channels or 1
                codec, bits = _voc_codec(sub[1])
            extents.append((body + 2, size - 2))
        elif btype == 2:  # continuation
            extents.append((body, size))
        elif btype == 8:  # extension (precedes a type-1 block)
            sub = f.read(4)
            if len(sub) < 4 or size < 4:
                raise LegacyError("truncated VOC extension block")
            (tc,) = struct.unpack("<H", sub[:2])
            channels = 2 if sub[3] else 1
            ext_rate = int(round(256000000.0 / (65536 - tc) / channels))
        elif btype == 9:  # v1.20 extended sound data
            sub = f.read(12)
            if len(sub) < 12 or size < 12:
                raise LegacyError("truncated VOC extended block")
            if rate is None:
                rate, b9bits, b9ch, fmt = struct.unpack("<IBBH", sub[:8])
                del b9bits
                channels = b9ch
                codec, bits = _voc_codec(fmt)
            extents.append((body + 12, size - 12))
        # types 3..7 (silence, markers, text, loops): no audio payload
        pos = body + size
    if rate is None or codec is None or not extents or not channels:
        raise LegacyError("no sound data in VOC file")
    nbytes = sum(s for _, s in extents)
    frames = nbytes // (_STORAGE[codec] * channels)
    info = AudioInfo(rate=int(rate), channels=int(channels), frames=frames,
                     container=Container.VOC, codec=codec,
                     bits_per_sample=bits)
    return info, extents, True


def parse_voc(blob: bytes):
    """In-memory convenience wrapper used by tests."""
    import io

    return _walk_voc(io.BytesIO(blob))


def _voc_codec(fmt: int):
    if fmt == 0:
        return SampleCodec.PCM_U8, 8
    if fmt == 4:
        return SampleCodec.PCM_16, 16
    if fmt == 6:
        return SampleCodec.ALAW, 16
    if fmt == 7:
        return SampleCodec.ULAW, 16
    raise LegacyError(f"unsupported VOC codec {fmt}")


def read_voc(path: str):
    with open(path, "rb") as f:
        info, extents, little = _walk_voc(f)
        parts = []
        for o, s in extents:
            f.seek(o)
            parts.append(f.read(s))
        raw = b"".join(parts)
    x = _pcm_decode(raw, info.codec, little)
    n = x.size // info.channels
    info.frames = n
    return x[: n * info.channels].reshape(n, info.channels), info


def read_voc_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        return _walk_voc(f)[0]


def open_voc_stream(path: str):
    with open(path, "rb") as f:
        info, extents, little = _walk_voc(f)
    if len(extents) != 1:
        return None  # multi-block payload: caller uses the whole-file read
    return _make_stream(path, info, extents[0][0], little)


class VocStreamEncoder(PcmStreamEncoderBase):
    """VOC output: v1.20 header + one type-9 block + terminator."""

    _allowed_bits = (16,)
    _little_endian = True
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata  # VOC has no tag block
        version = 0x0114
        out = _VOC_MAGIC + struct.pack(
            "<HHH", 26, version, (~version + 0x1234) & 0xFFFF
        )
        payload = self.total_frames * self.channels * 2
        out += bytes([9]) + (payload + 12).to_bytes(3, "little")
        out += struct.pack("<IBBH", self.rate, 16, self.channels, 4)
        out += bytes(4)
        return out

    def finish(self) -> bytes:
        return b"\x00"  # terminator block


# ---------------------------------------------------------------------------
# IRCAM (.sf)
# ---------------------------------------------------------------------------

# (magic bytes) -> little-endian payload?
_IRCAM_MAGICS = {
    b"\x64\xa3\x01\x00": True,   # VAX LE
    b"\x64\xa3\x02\x00": False,  # Sun BE
    b"\x64\xa3\x03\x00": True,   # MIPS LE (what libsndfile writes)
    b"\x64\xa3\x04\x00": False,  # NeXT BE
    b"\x00\x01\xa3\x64": False,  # byte-swapped variants
    b"\x00\x02\xa3\x64": True,
    b"\x00\x03\xa3\x64": False,
    b"\x00\x04\xa3\x64": True,
}
_IRCAM_CODECS = {
    0x00001: (SampleCodec.PCM_S8, 8),
    0x00002: (SampleCodec.PCM_16, 16),
    0x00004: (SampleCodec.FLOAT, 32),
    0x40004: (SampleCodec.PCM_32, 32),  # 32-bit linear int
    0x10001: (SampleCodec.ALAW, 16),
    0x20001: (SampleCodec.ULAW, 16),
}


def parse_ircam(head: bytes, total: int):
    little = _IRCAM_MAGICS.get(head[:4])
    if little is None or len(head) < 16:
        raise LegacyError("not an IRCAM file")
    e = "<" if little else ">"
    rate, channels, fmt = struct.unpack(e + "fII", head[4:16])
    codec_bits = _IRCAM_CODECS.get(fmt)
    if codec_bits is None or channels == 0 or not (0 < rate < 1e7):
        raise LegacyError(f"unsupported IRCAM layout fmt={fmt:#x}")
    codec, bits = codec_bits
    frames = max(0, total - 1024) // (_STORAGE[codec] * channels)
    info = AudioInfo(rate=int(round(rate)), channels=int(channels),
                     frames=frames, container=Container.IRCAM, codec=codec,
                     bits_per_sample=bits)
    return info, little


def read_ircam_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(16)
        f.seek(0, 2)
        total = f.tell()
    return parse_ircam(head, total)[0]


def open_ircam_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(16)
        f.seek(0, 2)
        total = f.tell()
    info, little = parse_ircam(head, total)
    return _make_stream(path, info, 1024, little)


def read_ircam(path: str):
    f, info, off, fb, decode = open_ircam_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read())
    info.frames = x.shape[0]
    return x, info


class IrcamStreamEncoder(PcmStreamEncoderBase):
    """IRCAM output: the MIPS-LE variant libsndfile writes."""

    _allowed_bits = (16,)
    _little_endian = True
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        out = b"\x64\xa3\x03\x00" + struct.pack(
            "<fII", float(self.rate), self.channels, 0x00002
        )
        return out + bytes(1024 - len(out))


# ---------------------------------------------------------------------------
# NIST SPHERE
# ---------------------------------------------------------------------------


def parse_nist(head: bytes, total: int):
    if not head.startswith(b"NIST_1A\n"):
        raise LegacyError("not a NIST SPHERE file")
    try:
        hdr_size = int(head[8:16].strip())
    except ValueError:
        raise LegacyError("bad NIST header size") from None
    fields = {}
    for line in head[16:hdr_size].split(b"\n"):
        parts = line.strip().split(b" ", 2)
        if len(parts) == 3:
            fields[parts[0].decode("ascii", "replace")] = parts[2]
        elif parts and parts[0] == b"end_head":
            break
    try:
        rate = int(fields["sample_rate"])
        channels = int(fields["channel_count"])
    except (KeyError, ValueError):
        raise LegacyError("missing NIST fields") from None
    nbytes = int(fields.get("sample_n_bytes", b"2"))
    coding = fields.get("sample_coding", b"pcm").decode("ascii", "replace")
    byte_format = fields.get("sample_byte_format", b"01").decode()
    little = byte_format != "10"
    # EXACT coding match: "pcm,embedded-shorten-v2.00" (TIMIT-style
    # compressed SPHERE) must be rejected, not decoded as raw PCM.
    if coding == "pcm" and nbytes == 2:
        codec, bits = SampleCodec.PCM_16, 16
    elif coding in ("ulaw", "mu-law"):
        codec, bits = SampleCodec.ULAW, 16
    elif coding == "alaw":
        codec, bits = SampleCodec.ALAW, 16
    elif coding == "pcm" and nbytes == 1:
        codec, bits = SampleCodec.PCM_S8, 8
    elif coding == "pcm" and nbytes == 3:
        codec, bits = SampleCodec.PCM_24, 24
    elif coding == "pcm" and nbytes == 4:
        codec, bits = SampleCodec.PCM_32, 32
    else:
        raise LegacyError(f"unsupported NIST coding {coding}/{nbytes}")
    frames = max(0, total - hdr_size) // (_STORAGE[codec] * channels)
    declared = fields.get("sample_count")
    if declared is not None:
        try:
            frames = min(frames, int(declared))
        except ValueError:
            pass
    info = AudioInfo(rate=rate, channels=channels, frames=frames,
                     container=Container.NIST, codec=codec,
                     bits_per_sample=bits)
    return info, hdr_size, little


def read_nist_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(4096)
        f.seek(0, 2)
        total = f.tell()
    return parse_nist(head, total)[0]


def open_nist_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(4096)
        f.seek(0, 2)
        total = f.tell()
    info, hdr_size, little = parse_nist(head, total)
    return _make_stream(path, info, hdr_size, little)


def read_nist(path: str):
    f, info, off, fb, decode = open_nist_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read(info.frames * fb))
    info.frames = x.shape[0]
    return x, info


class NistStreamEncoder(PcmStreamEncoderBase):
    """NIST SPHERE output: 1024-byte ASCII header + LE PCM-16."""

    _allowed_bits = (16,)
    _little_endian = True
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        text = (
            "NIST_1A\n   1024\n"
            f"channel_count -i {self.channels}\n"
            f"sample_rate -i {self.rate}\n"
            "sample_n_bytes -i 2\n"
            "sample_sig_bits -i 16\n"
            "sample_coding -s3 pcm\n"
            "sample_byte_format -s2 01\n"
            f"sample_count -i {self.total_frames}\n"
            "end_head\n"
        ).encode("ascii")
        return text + bytes(1024 - len(text))


# ---------------------------------------------------------------------------
# 8SVX / 16SV (Amiga IFF; read-only, effectively mono)
# ---------------------------------------------------------------------------


def _walk_svx(f):
    f.seek(0)
    head = f.read(12)
    if len(head) < 12 or head[:4] != b"FORM" or head[8:12] not in (
        b"8SVX", b"16SV",
    ):
        raise LegacyError("not an 8SVX/16SV file")
    sixteen = head[8:12] == b"16SV"
    f.seek(0, 2)
    total = f.tell()
    pos = 12
    rate = None
    body_off = body_len = None
    while pos + 8 <= total:
        f.seek(pos)
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid = hdr[:4]
        (size,) = struct.unpack(">I", hdr[4:8])
        body = pos + 8
        if cid == b"VHDR" and size >= 14:
            sub = f.read(16 if size >= 16 else 14)
            if len(sub) < 14:
                raise LegacyError("truncated VHDR")
            (rate,) = struct.unpack(">H", sub[12:14])
            if len(sub) >= 16 and sub[15] != 0:
                raise LegacyError("compressed 8SVX not supported")
        elif cid == b"CHAN" and size >= 4:
            (mask,) = struct.unpack(">I", f.read(4))
            if mask == 6:
                # Amiga stereo BODY data is PLANAR (all left, then all
                # right); reject like libsndfile rather than serve a
                # scrambled interleaved decode.
                raise LegacyError("stereo 8SVX not supported")
        elif cid == b"BODY":
            body_off, body_len = body, min(size, max(0, total - body))
        pos = body + size + (size & 1)
    if rate is None or body_off is None:
        raise LegacyError("missing VHDR/BODY chunks")
    codec = SampleCodec.PCM_16 if sixteen else SampleCodec.PCM_S8
    bits = 16 if sixteen else 8
    frames = body_len // _STORAGE[codec]
    info = AudioInfo(rate=int(rate), channels=1, frames=frames,
                     container=Container.SVX, codec=codec,
                     bits_per_sample=bits)
    return info, body_off, False  # big-endian


def parse_svx(blob: bytes):
    """In-memory convenience wrapper used by tests."""
    import io

    return _walk_svx(io.BytesIO(blob))


def read_svx(path: str):
    with open(path, "rb") as f:
        info, off, little = _walk_svx(f)
        f.seek(off)
        raw = f.read(info.frames * _STORAGE[info.codec])
    x = _pcm_decode(raw, info.codec, little)
    info.frames = x.size
    return x.reshape(-1, 1), info


def read_svx_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        return _walk_svx(f)[0]


def open_svx_stream(path: str):
    with open(path, "rb") as f:
        info, off, little = _walk_svx(f)
    return _make_stream(path, info, off, little)


# ---------------------------------------------------------------------------
# PVF (Portable Voice Format)
# ---------------------------------------------------------------------------


def parse_pvf(head: bytes, total: int):
    if not head.startswith(b"PVF1\n"):
        raise LegacyError("not a PVF file")
    nl = head.find(b"\n", 5)
    if nl < 0:
        raise LegacyError("bad PVF header")
    try:
        channels, rate, bits = (int(v) for v in head[5:nl].split())
    except ValueError:
        raise LegacyError("bad PVF fields") from None
    codec = {8: SampleCodec.PCM_S8, 16: SampleCodec.PCM_16,
             32: SampleCodec.PCM_32}.get(bits)
    if codec is None or channels == 0:
        raise LegacyError(f"unsupported PVF layout {channels}/{bits}")
    offset = nl + 1
    frames = max(0, total - offset) // (_STORAGE[codec] * channels)
    info = AudioInfo(rate=rate, channels=channels, frames=frames,
                     container=Container.PVF, codec=codec,
                     bits_per_sample=bits)
    return info, offset, False  # big-endian payload


def read_pvf_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(64)
        f.seek(0, 2)
        total = f.tell()
    return parse_pvf(head, total)[0]


def open_pvf_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(64)
        f.seek(0, 2)
        total = f.tell()
    info, off, little = parse_pvf(head, total)
    return _make_stream(path, info, off, little)


def read_pvf(path: str):
    f, info, off, fb, decode = open_pvf_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read())
    info.frames = x.shape[0]
    return x, info


class PvfStreamEncoder(PcmStreamEncoderBase):
    """PVF output: ASCII header + big-endian PCM-16."""

    _allowed_bits = (16,)
    _little_endian = False
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        return f"PVF1\n{self.channels} {self.rate} 16\n".encode("ascii")


# ---------------------------------------------------------------------------
# PAF (Ensoniq PARIS)
# ---------------------------------------------------------------------------

_PAF_CODECS = {
    0: (SampleCodec.PCM_16, 16),
    1: (SampleCodec.PCM_24, 24),  # block-packed, see _decode_paf24
    2: (SampleCodec.PCM_S8, 8),
}

# PAF 24-bit block layout (probed against the oracle with impulse
# files): the payload is a sequence of 32-byte units, each carrying 10
# samples as 3-byte little-endian values in the unit's LOGICAL byte
# stream (last 2 bytes pad); for the big-endian ' paf' variant the
# logical stream is the physical one with every int32's bytes reversed.
# Units round-robin across channels (unit k belongs to channel k % ch).
_PAF24_UNIT = 32
_PAF24_SPB = 10


def _decode_paf24(raw: bytes, channels: int, little: bool) -> np.ndarray:
    nu = len(raw) // (_PAF24_UNIT * channels) * channels
    raw = raw[: nu * _PAF24_UNIT]
    if nu == 0:
        return np.zeros((0, channels), np.float32)
    b = np.frombuffer(raw, np.uint8).reshape(-1, 4)
    if not little:
        b = b[:, ::-1]  # undo the big-endian int32 word order
    logical = np.ascontiguousarray(b).reshape(nu, _PAF24_UNIT)
    trip = logical[:, : _PAF24_SPB * 3].reshape(nu, _PAF24_SPB, 3)
    v = (trip[..., 0].astype(np.int32)
         | (trip[..., 1].astype(np.int32) << 8)
         | (trip[..., 2].astype(np.int32) << 16))
    v = (v << 8) >> 8  # sign-extend 24 bits
    # units: [ch0 u0][ch1 u0]...[ch0 u1]... -> [frame, ch]
    v = v.reshape(nu // channels, channels, _PAF24_SPB)
    x = v.transpose(0, 2, 1).reshape(-1, channels)
    return x.astype(np.float32) / 8388608.0


def parse_paf(head: bytes, total: int):
    if head[:4] == b" paf":
        little = False
        e = ">"
    elif head[:4] == b"fap ":
        little = True
        e = "<"
    else:
        raise LegacyError("not a PAF file")
    if len(head) < 24:
        raise LegacyError("truncated PAF header")
    _ver, _endian, rate, fmt, channels = struct.unpack(
        e + "IIIII", head[4:24]
    )
    codec_bits = _PAF_CODECS.get(fmt)
    if codec_bits is None or channels == 0 or not (0 < rate < 10 ** 7):
        raise LegacyError(f"unsupported PAF layout fmt={fmt}")
    codec, bits = codec_bits
    if fmt == 1:  # 24-bit: 32-byte units of 10 samples per channel
        groups = max(0, total - 2048) // (_PAF24_UNIT * channels)
        frames = groups * _PAF24_SPB
    else:
        frames = max(0, total - 2048) // (_STORAGE[codec] * channels)
    info = AudioInfo(rate=int(rate), channels=int(channels), frames=frames,
                     container=Container.PAF, codec=codec,
                     bits_per_sample=bits)
    return info, 2048, little


def read_paf_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(24)
        f.seek(0, 2)
        total = f.tell()
    return parse_paf(head, total)[0]


def open_paf_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(24)
        f.seek(0, 2)
        total = f.tell()
    info, off, little = parse_paf(head, total)
    if info.codec == SampleCodec.PCM_24:
        from folve_tpu_torch.audio.source import BlockSource

        src = BlockSource(
            open(path, "rb"), info, off, _PAF24_UNIT * info.channels,
            _PAF24_SPB,
            lambda raw: _decode_paf24(raw, info.channels, little))
        return None, src, off, 0, None
    return _make_stream(path, info, off, little)


def read_paf(path: str):
    stream = open_paf_stream(path)
    if stream[0] is None:  # 24-bit block source
        from folve_tpu_torch.audio.source import drain_source

        return drain_source(stream[1])
    f, info, off, fb, decode = stream
    with f:
        f.seek(off)
        x = decode(f.read())
    info.frames = x.shape[0]
    return x, info


class PafStreamEncoder(PcmStreamEncoderBase):
    """PAF output: big-endian variant, PCM-16 or the 24-bit
    block-packed fmt-1 (a 24-bit PAF input keeps its depth, matching
    the reference's format-preserving write).  24-bit buffers to
    10-sample units per channel; the final partial unit is zero-padded
    (libsndfile pads with stale buffer bytes — zeros are strictly
    saner and readers derive the ceil'd frame count either way)."""

    _allowed_bits = (16, 24)
    _little_endian = False
    _error = LegacyError

    def __init__(self, rate, channels, bits, total_frames):
        super().__init__(rate, channels, bits, total_frames)
        self._pend = np.zeros((0, channels), np.int32)

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        fmt = 1 if self.bits == 24 else 0
        out = b" paf" + struct.pack(">IIIII", 0, 0, self.rate, fmt,
                                    self.channels)
        return out + bytes(2048 - len(out))

    def _pack24(self, vals: np.ndarray) -> bytes:
        """Whole units [n*10, ch] int32 -> fmt-1 bytes (per-channel
        32-byte units of 10 3-byte-LE samples in the word-reversed
        logical stream — the decode layout in _decode_paf24, inverted)."""
        nu = vals.shape[0] // _PAF24_SPB
        v = vals.reshape(nu, _PAF24_SPB, self.channels)
        out = np.zeros((nu, self.channels, _PAF24_UNIT), np.uint8)
        u = v.transpose(0, 2, 1).astype(np.int64) & 0xFFFFFF
        trip = out[:, :, : _PAF24_SPB * 3].reshape(nu, self.channels,
                                                   _PAF24_SPB, 3)
        trip[..., 0] = u & 0xFF
        trip[..., 1] = (u >> 8) & 0xFF
        trip[..., 2] = (u >> 16) & 0xFF
        # logical -> physical: reverse bytes within each int32 word
        phys = out.reshape(-1, 4)[:, ::-1]
        return np.ascontiguousarray(phys).tobytes()

    def write_float(self, samples: np.ndarray) -> bytes:
        if self.bits == 16:
            return super().write_float(samples)
        v = np.clip(
            np.round(np.asarray(samples, np.float64) * self._scale),
            -self._scale, self._limit).astype(np.int32)
        self._pend = np.concatenate([self._pend, v.reshape(-1, self.channels)])
        whole = (self._pend.shape[0] // _PAF24_SPB) * _PAF24_SPB
        if whole == 0:
            return b""
        chunk, self._pend = self._pend[:whole], self._pend[whole:]
        return self._pack24(chunk)

    def finish(self) -> bytes:
        if self.bits == 16 or self._pend.shape[0] == 0:
            return b""
        pad = _PAF24_SPB - self._pend.shape[0]
        tail = np.concatenate(
            [self._pend, np.zeros((pad, self.channels), np.int32)])
        self._pend = np.zeros((0, self.channels), np.int32)
        return self._pack24(tail)


# ---------------------------------------------------------------------------
# AVR (Audio Visual Research)
# ---------------------------------------------------------------------------


def parse_avr(head: bytes, total: int):
    if head[:4] != b"2BIT" or len(head) < 32:
        raise LegacyError("not an AVR file")
    mono, rez, sign = struct.unpack(">HHH", head[12:18])
    (rate,) = struct.unpack(">I", head[22:26])
    rate &= 0x00FFFFFF  # top byte carries flags
    (size,) = struct.unpack(">I", head[26:30])
    channels = 2 if mono == 0xFFFF else 1
    if rez == 16 and sign == 0xFFFF:
        codec, bits = SampleCodec.PCM_16, 16
    elif rez == 8 and sign == 0xFFFF:
        codec, bits = SampleCodec.PCM_S8, 8
    elif rez == 8:
        codec, bits = SampleCodec.PCM_U8, 8
    else:
        raise LegacyError(f"unsupported AVR layout rez={rez} sign={sign}")
    if not (0 < rate < 10 ** 7):
        raise LegacyError("bad AVR rate")
    frames = max(0, total - 128) // (_STORAGE[codec] * channels)
    if size:
        frames = min(frames, size)
    info = AudioInfo(rate=int(rate), channels=channels, frames=frames,
                     container=Container.AVR, codec=codec,
                     bits_per_sample=bits)
    return info, 128, False  # big-endian


def read_avr_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(32)
        f.seek(0, 2)
        total = f.tell()
    return parse_avr(head, total)[0]


def open_avr_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(32)
        f.seek(0, 2)
        total = f.tell()
    info, off, little = parse_avr(head, total)
    return _make_stream(path, info, off, little)


def read_avr(path: str):
    f, info, off, fb, decode = open_avr_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read(info.frames * fb))
    info.frames = x.shape[0]
    return x, info


class AvrStreamEncoder(PcmStreamEncoderBase):
    """AVR output: big-endian signed PCM-16."""

    _allowed_bits = (16,)
    _little_endian = False
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        out = b"2BIT" + bytes(8)  # empty sample name
        out += struct.pack(">HHHHH", 0xFFFF if self.channels == 2 else 0,
                           16, 0xFFFF, 0, 0xFFFF)  # midi 0xffff = unpitched
        out += struct.pack(">I", self.rate & 0x00FFFFFF)
        out += struct.pack(">III", self.total_frames, 0, 0)
        return out + bytes(128 - len(out))


# ---------------------------------------------------------------------------
# WVE (Psion A-law; always 8 kHz mono)
# ---------------------------------------------------------------------------


def _alaw_encode(v: np.ndarray) -> np.ndarray:
    """Linear int16 -> G.711 A-law bytes, byte-exact vs the libsndfile
    oracle (validated over all 65536 inputs): code = alaw(|v|) with the
    sign bit set for v >= 0 (A-law MSB 1 = positive — see _alaw_table
    in audio/au.py for the decode side of the same convention)."""
    v = np.asarray(v, np.int64)
    x = np.minimum(np.abs(v), 32767)
    pcm = x >> 3  # 13-bit magnitude
    seg = np.zeros_like(pcm)
    for i, e in enumerate([0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF]):
        seg = np.where(pcm > e, i + 1, seg)
    mant = np.where(seg < 2, (pcm >> 1) & 0xF, (pcm >> seg) & 0xF)
    code = (((seg << 4) | mant) ^ 0x55) | np.where(v >= 0, 0x80, 0)
    return code.astype(np.uint8)


class WveStreamEncoder(PcmStreamEncoderBase):
    """WVE output: 32-byte Psion header + A-law bytes (the container's
    only codec).  Same-container policy (convolve-file-handler.cc:
    249-251); the reference's libsndfile writer emits the identical
    header and byte-exact A-law codes."""

    _allowed_bits = (16,)
    _little_endian = True
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        return (b"ALawSoundFile**\x00" + struct.pack(">H", 0x0F10)
                + struct.pack(">I", self.total_frames) + bytes(10))

    def write_float(self, samples: np.ndarray) -> bytes:
        v = np.clip(
            np.round(np.asarray(samples, dtype=np.float64) * 32768.0),
            -32768, 32767,
        ).astype(np.int16)
        return _alaw_encode(v.reshape(-1)).tobytes()


def parse_wve(head: bytes, total: int):
    if head[:15] != b"ALawSoundFile**" or len(head) < 32:
        raise LegacyError("not a WVE file")
    frames = max(0, total - 32)
    info = AudioInfo(rate=8000, channels=1, frames=frames,
                     container=Container.WVE, codec=SampleCodec.ALAW,
                     bits_per_sample=16)
    return info, 32, False


def read_wve_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(32)
        f.seek(0, 2)
        total = f.tell()
    return parse_wve(head, total)[0]


def open_wve_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(32)
        f.seek(0, 2)
        total = f.tell()
    info, off, little = parse_wve(head, total)
    return _make_stream(path, info, off, little)


def read_wve(path: str):
    f, info, off, fb, decode = open_wve_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read())
    info.frames = x.shape[0]
    return x, info


# ---------------------------------------------------------------------------
# MAT4 / MAT5 (Matlab audio files, libsndfile's wavedata convention)
# ---------------------------------------------------------------------------


class Mat5StreamEncoder(PcmStreamEncoderBase):
    """MAT5 output: 128-byte text header + `samplerate` and `wavedata`
    miMATRIX elements, int16 little-endian (same-container policy,
    convolve-file-handler.cc:249-251).  Element layout mirrors the
    libsndfile writer byte-for-byte, including its wavedata length
    field overshooting the payload by 8 (both its reader and ours
    tolerate that).  Matlab matrices are column-major, so dims
    [channels, frames] makes the element data plain interleaved
    frames."""

    _allowed_bits = (16,)
    _little_endian = True
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        # libsndfile's reader requires the NUL after the description.
        text = b"MATLAB 5.0 MAT-file, written by folve-tpu\x00"
        head = text + b" " * (124 - len(text))
        head += struct.pack("<H", 0x0100) + b"IM"
        # samplerate: 1x1 matrix, value as a small miUINT16/miUINT32.
        if self.rate <= 0xFFFF:
            val = struct.pack("<HHH", 4, 2, self.rate) + b"\x00\x00"
        else:
            val = struct.pack("<HHI", 6, 4, self.rate)
        sr = (struct.pack("<II", 6, 8) + struct.pack("<II", 6, 0)      # flags
              + struct.pack("<II", 5, 8) + struct.pack("<ii", 1, 1)    # dims
              + struct.pack("<II", 1, 10) + b"samplerate" + bytes(6)   # name
              + val)
        head += struct.pack("<II", 14, len(sr)) + sr
        # wavedata: [channels, frames] int16 matrix; data follows the
        # header and is padded to 8 in finish().
        nbytes = 2 * self.channels * self.total_frames
        padded = (nbytes + 7) & ~7
        wd = (struct.pack("<II", 6, 8) + struct.pack("<II", 6, 0)
              + struct.pack("<II", 5, 8)
              + struct.pack("<ii", self.channels, self.total_frames)
              + struct.pack("<II", 1, 8) + b"wavedata"
              + struct.pack("<II", 3, nbytes))
        head += struct.pack("<II", 14, len(wd) + padded + 8) + wd
        self._written = 0
        return head

    def write_float(self, samples: np.ndarray) -> bytes:
        out = super().write_float(samples)
        self._written += len(out)
        return out

    def finish(self) -> bytes:
        pad = (-self._written) % 8
        return bytes(pad)


def _mat_finish(rate, data, channels,
                codec=SampleCodec.PCM_16, bits=16):
    if rate is None or data is None:
        raise LegacyError("missing samplerate/wavedata matrices")
    n = data.shape[0]
    # Report the wavedata's REAL element type: the output-depth policy
    # keys off bits_per_sample (a double MAT must serve FLAC/24, not be
    # squeezed through the int16 MAT5 writer).
    info = AudioInfo(rate=int(round(rate)), channels=channels, frames=n,
                     container=Container.MAT, codec=codec,
                     bits_per_sample=bits)
    return data, info


def read_mat4(path: str):
    with open(path, "rb") as f:
        blob = f.read()
    pos = 0
    rate = None
    data = None
    channels = 1
    codec, bits = SampleCodec.PCM_16, 16
    while pos + 20 <= len(blob):
        mtype, mrows, ncols, imagf, namelen = struct.unpack(
            "<IIIII", blob[pos : pos + 20]
        )
        if mtype > 9999 or namelen > 64 or mrows > 1 << 24 or ncols > 1 << 24:
            raise LegacyError("bad MAT4 element")
        if (mtype // 1000) % 10:
            raise LegacyError("big-endian MAT4 files are not supported")
        name = blob[pos + 20 : pos + 20 + namelen].rstrip(b"\0")
        body = pos + 20 + namelen
        p_code = (mtype // 10) % 10  # precision digit
        elem = {0: 8, 1: 4, 2: 4, 3: 2, 4: 2, 5: 1}.get(p_code)
        if elem is None:
            raise LegacyError(f"bad MAT4 precision {p_code}")
        count = mrows * ncols * (2 if imagf else 1)
        raw = blob[body : body + count * elem]
        dt = {0: "<f8", 1: "<f4", 2: "<i4", 3: "<i2", 4: "<u2", 5: "u1"}[p_code]
        vals = np.frombuffer(raw[: (len(raw) // elem) * elem], dt)
        if name == b"samplerate" and vals.size:
            rate = float(vals[0])
        elif name == b"wavedata" and mrows:
            channels = int(mrows) if mrows <= 64 else 1
            n = vals.size // channels
            m = vals[: n * channels].reshape(n, channels)  # column-major
            if p_code == 3:  # int16
                data = m.astype(np.float32) / 32768.0
            elif p_code == 0:  # double
                data = m.astype(np.float32)
                codec, bits = SampleCodec.DOUBLE, 64
            elif p_code == 1:  # float32
                data = m.astype(np.float32)
                codec, bits = SampleCodec.FLOAT, 32
            elif p_code == 2:
                data = m.astype(np.float32) / 2147483648.0
                codec, bits = SampleCodec.PCM_32, 32
            else:
                raise LegacyError("unsupported MAT4 wavedata type")
        pos = body + count * elem
    return _mat_finish(rate, data, channels, codec, bits)


def _mat5_element(blob, pos):
    """-> (mtype, body_off, body_len, next_pos) handling the small
    element format."""
    if pos + 8 > len(blob):
        return None
    (tag,) = struct.unpack("<I", blob[pos : pos + 4])
    if tag >> 16:  # small element: length in the high half
        return tag & 0xFFFF, pos + 4, tag >> 16, pos + 8
    (length,) = struct.unpack("<I", blob[pos + 4 : pos + 8])
    if length > len(blob):
        raise LegacyError("bad MAT5 element length")
    padded = (length + 7) & ~7
    return tag, pos + 8, length, pos + 8 + padded


_MAT5_DTYPES = {1: "i1", 2: "u1", 3: "<i2", 4: "<u2", 5: "<i4", 6: "<u4",
                7: "<f4", 9: "<f8"}


def read_mat5(path: str):
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 128 or blob[124:128] not in (b"\x00\x01IM", b"\x01\x00MI"):
        # version+endian indicator; libsndfile writes little-endian 'IM'
        if len(blob) < 128 or blob[126:128] != b"IM":
            raise LegacyError("not a little-endian MAT5 file")
    pos = 128
    rate = None
    data = None
    channels = 1
    codec, bits = SampleCodec.PCM_16, 16
    while True:
        el = _mat5_element(blob, pos)
        if el is None:
            break
        mtype, off, length, pos = el
        if mtype != 14:  # miMATRIX
            continue
        # inside: arrayflags, dims, name, real part
        p = off
        end = off + length
        fields = []
        while p < end and len(fields) < 4:
            sub = _mat5_element(blob, p)
            if sub is None or sub[1] + sub[2] > end + 8:
                break
            fields.append(sub)
            p = sub[3]
        if len(fields) < 4:
            continue
        (_, doff, dlen, _) = fields[1]
        dims = np.frombuffer(blob[doff : doff + dlen], "<i4")
        (_, noff, nlen, _) = fields[2]
        name = blob[noff : noff + nlen].rstrip(b"\0")
        (dtype_code, voff, vlen, _) = fields[3]
        dt = _MAT5_DTYPES.get(dtype_code)
        if dt is None:
            continue
        vals = np.frombuffer(blob[voff : voff + vlen], dt)
        if name == b"samplerate" and vals.size:
            rate = float(vals[0])
        elif name == b"wavedata" and dims.size >= 2:
            channels = int(dims[0]) if 0 < dims[0] <= 64 else 1
            n = vals.size // channels
            m = vals[: n * channels].reshape(n, channels)
            if dt == "<i2":
                data = m.astype(np.float32) / 32768.0
            elif dt == "<f4":
                data = m.astype(np.float32)
                codec, bits = SampleCodec.FLOAT, 32
            elif dt == "<f8":
                data = m.astype(np.float32)
                codec, bits = SampleCodec.DOUBLE, 64
            elif dt == "<i4":
                data = m.astype(np.float32) / 2147483648.0
                codec, bits = SampleCodec.PCM_32, 32
            elif dt == "u1":  # miUINT8, offset-binary
                data = (m.astype(np.float32) - 128.0) / 128.0
                codec, bits = SampleCodec.PCM_U8, 8
            else:
                raise LegacyError("unsupported MAT5 wavedata type")
    return _mat_finish(rate, data, channels, codec, bits)


def read_mat4_info(path: str) -> AudioInfo:
    return read_mat4(path)[1]


def read_mat5_info(path: str) -> AudioInfo:
    return read_mat5(path)[1]


def read_mat(path: str):
    with open(path, "rb") as f:
        magic = f.read(6)
    if magic == b"MATLAB":
        return read_mat5(path)
    return read_mat4(path)


def read_mat_info(path: str) -> AudioInfo:
    return read_mat(path)[1]


def open_mat_stream(path: str):
    # MAT matrices carry no incremental framing worth streaming; the
    # source layer falls back to a whole-file _MemorySource (these are
    # scientific interchange files, not production audio).
    return None


# ---------------------------------------------------------------------------
# HTK (speech-toolkit waveform; 12-byte header, BE PCM-16, mono)
# ---------------------------------------------------------------------------


class HtkStreamEncoder(PcmStreamEncoderBase):
    """HTK output: 12-byte header (nsamples, period in 100 ns units,
    sampSize=2, parmKind=0 WAVEFORM) + big-endian PCM-16.  HTK is
    mono-only; the handler falls back to FLAC for multichannel output
    (same policy as other constrained legacy containers)."""

    _allowed_bits = (16,)
    _little_endian = False
    _error = LegacyError

    def __init__(self, rate: int, channels: int, bits: int,
                 total_frames: int):
        if channels != 1:
            raise LegacyError("HTK is mono-only")
        super().__init__(rate, channels, bits, total_frames)

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        period = max(1, int(round(1e7 / self.rate)))
        return struct.pack(">IIHH", self.total_frames, period, 2, 0)


def parse_htk(head: bytes, total: int):
    if len(head) < 12:
        raise LegacyError("truncated HTK header")
    nsamples, period, samp_size, parm_kind = struct.unpack(">IIHH", head[:12])
    # parmKind 0 == WAVEFORM; period in 100 ns units
    if parm_kind != 0 or samp_size != 2 or period == 0:
        raise LegacyError("not an HTK waveform file")
    rate = int(round(1e7 / period))
    if not (100 <= rate <= 400000) or nsamples * 2 + 12 != total:
        raise LegacyError("inconsistent HTK header")
    info = AudioInfo(rate=rate, channels=1, frames=nsamples,
                     container=Container.HTK, codec=SampleCodec.PCM_16,
                     bits_per_sample=16)
    return info, 12, False  # big-endian


def sniff_htk(path: str) -> bool:
    """HTK has no magic; accept only a fully consistent header."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            f.seek(0, 2)
            total = f.tell()
        parse_htk(head, total)
        return True
    except (LegacyError, OSError):
        return False


def read_htk_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(12)
        f.seek(0, 2)
        total = f.tell()
    return parse_htk(head, total)[0]


def open_htk_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(12)
        f.seek(0, 2)
        total = f.tell()
    info, off, little = parse_htk(head, total)
    return _make_stream(path, info, off, little)


def read_htk(path: str):
    f, info, off, fb, decode = open_htk_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read())
    info.frames = x.shape[0]
    return x, info


# ---------------------------------------------------------------------------
# MPC2K (Akai MPC-2000 sample; 42-byte header, LE PCM-16)
# ---------------------------------------------------------------------------


def parse_mpc(head: bytes, total: int):
    if len(head) < 42 or head[0] != 1 or head[1] != 4:
        raise LegacyError("not an MPC2000 file")
    channels = 2 if head[21] else 1
    (frames,) = struct.unpack("<I", head[26:30])
    (rate,) = struct.unpack("<H", head[40:42])
    if rate == 0 or frames * 2 * channels + 42 != total:
        raise LegacyError("inconsistent MPC2000 header")
    info = AudioInfo(rate=int(rate), channels=channels, frames=frames,
                     container=Container.MPC, codec=SampleCodec.PCM_16,
                     bits_per_sample=16)
    return info, 42, True  # little-endian


def sniff_mpc(path: str) -> bool:
    """Two-byte magic only; require full header consistency."""
    try:
        with open(path, "rb") as f:
            head = f.read(42)
            f.seek(0, 2)
            total = f.tell()
        parse_mpc(head, total)
        return True
    except (LegacyError, OSError):
        return False


def read_mpc_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(42)
        f.seek(0, 2)
        total = f.tell()
    return parse_mpc(head, total)[0]


def open_mpc_stream(path: str):
    with open(path, "rb") as f:
        head = f.read(42)
        f.seek(0, 2)
        total = f.tell()
    info, off, little = parse_mpc(head, total)
    return _make_stream(path, info, off, little)


def read_mpc(path: str):
    f, info, off, fb, decode = open_mpc_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read(info.frames * fb))
    info.frames = x.shape[0]
    return x, info


class MpcStreamEncoder(PcmStreamEncoderBase):
    """MPC2000 output: little-endian PCM-16, mono or stereo."""

    _allowed_bits = (16,)
    _little_endian = True
    _error = LegacyError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        del metadata
        if self.channels not in (1, 2):
            raise LegacyError("MPC2000 carries 1 or 2 channels")
        if self.rate > 0xFFFF:
            raise LegacyError("MPC2000 cannot carry rates above 65535 Hz")
        out = bytearray(42)
        out[0], out[1] = 1, 4
        out[2:20] = b"folve.mpc".ljust(18)
        out[21] = self.channels - 1
        struct.pack_into("<III", out, 26, self.total_frames,
                         self.total_frames, self.total_frames)
        out[39] = 1  # observed fixed byte in oracle files
        struct.pack_into("<H", out, 40, self.rate)
        return bytes(out)


# ---------------------------------------------------------------------------
# SDS (MIDI Sample Dump Standard; 7-bit packed packets, mono)
# ---------------------------------------------------------------------------


def _septets(b3):
    """Three LSB-first MIDI septets -> 21-bit value."""
    s = [v & 0x7F for v in b3]
    return s[0] | (s[1] << 7) | (s[2] << 14)


def parse_sds_header(head: bytes):
    if len(head) < 21 or head[:2] != b"\xf0\x7e" or head[3] != 0x01:
        raise LegacyError("not an SDS dump header")
    fmt = head[6]
    if fmt not in (8, 16, 24):
        raise LegacyError(f"unsupported SDS word size {fmt}")
    period = _septets(head[7:10])
    length = _septets(head[10:13])
    if period == 0:
        raise LegacyError("bad SDS sample period")
    rate = int(round(1e9 / period))
    return fmt, rate, length


def read_sds(path: str):
    with open(path, "rb") as f:
        blob = f.read()
    fmt, rate, length = parse_sds_header(blob[:21])
    vals = []
    pos = 21
    # Septets per sample; the payload carries the FULL septet precision
    # in offset binary — nominal "8/16/24-bit" dumps actually hold
    # 14/21/28 significant bits (2/3/4 septets; libsndfile keeps every
    # bit through its float path, so matching it exactly means keeping
    # them all rather than truncating to the nominal width).
    per = {8: 2, 16: 3, 24: 4}[fmt]
    mid = 1 << (7 * per - 1)
    while pos + 127 <= len(blob):
        if blob[pos : pos + 2] != b"\xf0\x7e" or blob[pos + 3] != 0x02:
            break
        data = blob[pos + 5 : pos + 125]
        arr = np.frombuffer(data, np.uint8).astype(np.int64) & 0x7F
        arr = arr[: (arr.size // per) * per].reshape(-1, per)
        v = np.zeros(arr.shape[0], np.int64)
        for c in range(per):  # big-endian septets
            v = (v << 7) | arr[:, c]
        vals.append(v - mid)
        pos += 127
    flat = (np.concatenate(vals) if vals
            else np.zeros(0, np.int64))[:length]
    x = (flat.astype(np.float64) / mid).astype(np.float32).reshape(-1, 1)
    info = AudioInfo(
        rate=rate, channels=1, frames=x.shape[0],
        container=Container.SDS,
        codec=SampleCodec.PCM_24 if fmt == 24 else SampleCodec.PCM_16,
        bits_per_sample=fmt)
    return x, info


def read_sds_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        head = f.read(21)
        f.seek(0, 2)
        total = f.tell()
    fmt, rate, length = parse_sds_header(head)
    per_packet = {8: 60, 16: 40, 24: 30}[fmt]
    packets = max(0, (total - 21)) // 127
    frames = min(length, packets * per_packet)
    return AudioInfo(
        rate=rate, channels=1, frames=frames, container=Container.SDS,
        codec=SampleCodec.PCM_24 if fmt == 24 else SampleCodec.PCM_16,
        bits_per_sample=fmt)


def open_sds_stream(path: str):
    # packets are tiny (127 B); these are sampler-era files — whole read
    return None


# ---------------------------------------------------------------------------
# XI (FastTracker II Extended Instrument: DPCM-coded sample data)
# ---------------------------------------------------------------------------
#
# Layout (as libsndfile reads/writes it — validated against the oracle
# by header-mutation probes, tests/test_legacy_formats.py):
#   0   "Extended Instrument: " (21-byte magic)
#   21  instrument name (22), 0x1A marker @43, software (20), version u16
#   66  keymap/envelope block the audio layer ignores (230 bytes)
#   296 u16 LE sample count  (must be >= 1)
#   298 40-byte sample headers; byte 14 of the FIRST one carries the
#       0x10 16-bit flag.  Stored sample lengths are untrustworthy —
#       the frame count comes from the bytes after the headers.
#   298+n*40  DPCM payload: cumulative s8 (<<8 on output) or s16 LE
#       deltas, wrapping at the accumulator's natural width.
# XI is mono, and the container has no samplerate (it is an instrument
# format pitched by note); the oracle reports a fixed 44100.

_XI_MAGIC = b"Extended Instrument: "


def parse_xi(head: bytes, total: int):
    if len(head) < 338 or head[:21] != _XI_MAGIC or head[43] != 0x1A:
        raise LegacyError("not an XI instrument")
    (nsamples,) = struct.unpack("<H", head[296:298])
    if nsamples < 1:
        raise LegacyError("XI with no samples")
    offset = 298 + nsamples * 40
    if offset > total:
        raise LegacyError("XI sample headers past EOF")
    wide = bool(head[312] & 0x10)  # first sample header's type byte
    codec = SampleCodec.DPCM_16 if wide else SampleCodec.DPCM_8
    frames = max(0, total - offset) // (2 if wide else 1)
    info = AudioInfo(rate=44100, channels=1, frames=frames,
                     container=Container.XI, codec=codec,
                     bits_per_sample=16 if wide else 8)
    return info, offset


def read_xi_info(path: str) -> AudioInfo:
    import os

    with open(path, "rb") as f:
        head = f.read(338)
    return parse_xi(head, os.path.getsize(path))[0]


def read_xi(path: str):
    import os

    with open(path, "rb") as f:
        head = f.read(338)
        info, offset = parse_xi(head, os.path.getsize(path))
        f.seek(offset)
        raw = f.read()
    if info.codec == SampleCodec.DPCM_16:
        deltas = np.frombuffer(raw[: len(raw) - len(raw) % 2], "<i2")
        acc = np.cumsum(deltas.astype(np.int64))
        x = ((acc + 32768) & 0xFFFF) - 32768  # wrap like a C short
        x = x.astype(np.float32) / 32768.0
    else:
        deltas = np.frombuffer(raw, np.int8)
        acc = np.cumsum(deltas.astype(np.int64))
        x = ((acc + 128) & 0xFF) - 128  # wrap like a C char, then <<8
        x = x.astype(np.float32) / 128.0
    info.frames = x.shape[0]
    return x.reshape(-1, 1), info


def open_xi_stream(path: str):
    # DPCM needs the running sum from sample 0; XI instrument samples
    # are small, so the whole-read _MemorySource fallback handles them.
    return None


def sniff_xi(head: bytes) -> bool:
    return head[:12] == _XI_MAGIC[:12]


# ---------------------------------------------------------------------------
# SD2 (Sound Designer II: headerless BE PCM + Mac resource-fork metadata)
# ---------------------------------------------------------------------------

_APPLEDOUBLE_MAGIC = 0x00051607


def _sd2_rsrc_path(path: str) -> Optional[str]:
    import os

    d, base = os.path.split(path)
    for cand in (os.path.join(d, "._" + base), path + ".rsrc"):
        if os.path.exists(cand):
            return cand
    return None


def _resource_fork_strings(blob: bytes) -> dict:
    """Classic Mac resource fork -> {STR resource id: pascal-string
    payload}.  Accepts either a bare fork or an AppleDouble wrapper."""
    if len(blob) >= 26 and struct.unpack(">I", blob[:4])[0] == \
            _APPLEDOUBLE_MAGIC:
        (nent,) = struct.unpack(">H", blob[24:26])
        for i in range(nent):
            off = 26 + 12 * i
            if off + 12 > len(blob):
                break
            eid, eoff, elen = struct.unpack(">III", blob[off : off + 12])
            if eid == 2:  # resource fork entry
                blob = blob[eoff : eoff + elen]
                break
        else:
            raise LegacyError("AppleDouble file has no resource fork")
    if len(blob) < 16:
        raise LegacyError("truncated resource fork")
    data_off, map_off, data_len, map_len = struct.unpack(">IIII", blob[:16])
    if map_off + 28 > len(blob) or data_off > len(blob):
        raise LegacyError("bad resource fork header")
    m = blob[map_off : map_off + map_len]
    if len(m) < 30:
        raise LegacyError("truncated resource map")
    type_off, _name_off = struct.unpack(">HH", m[24:28])
    if type_off + 2 > len(m):
        raise LegacyError("bad resource type list")
    (ntypes,) = struct.unpack(">H", m[type_off : type_off + 2])
    out = {}
    p = type_off + 2
    for _ in range(min(ntypes + 1, 64)):
        if p + 8 > len(m):
            break
        rtype, cnt, ref_off = struct.unpack(">4sHH", m[p : p + 8])
        p += 8
        if rtype != b"STR ":
            continue
        rp = type_off + ref_off
        for _ in range(min(cnt + 1, 64)):
            if rp + 12 > len(m):
                break
            (rid,) = struct.unpack(">H", m[rp : rp + 2])
            d_off = int.from_bytes(m[rp + 4 : rp + 8], "big") & 0xFFFFFF
            dp = data_off + d_off
            if dp + 4 <= len(blob):
                (dl,) = struct.unpack(">I", blob[dp : dp + 4])
                payload = blob[dp + 4 : dp + 4 + dl]
                if payload and payload[0] + 1 <= len(payload):
                    out[rid] = payload[1 : 1 + payload[0]]
            rp += 12
    return out


_SD2_CODECS = {1: (SampleCodec.PCM_S8, 8), 2: (SampleCodec.PCM_16, 16),
               3: (SampleCodec.PCM_24, 24), 4: (SampleCodec.PCM_32, 32)}


def parse_sd2(path: str, total: int):
    rsrc = _sd2_rsrc_path(path)
    if rsrc is None:
        raise LegacyError("SD2 file has no resource fork")
    with open(rsrc, "rb") as f:
        strings = _resource_fork_strings(f.read(1 << 20))
    try:
        size = int(strings[1000])
        rate = int(round(float(strings[1001])))
        channels = int(strings[1002])
    except (KeyError, ValueError) as e:
        raise LegacyError(f"bad SD2 resource strings: {e}") from None
    codec_bits = _SD2_CODECS.get(size)
    if codec_bits is None or channels < 1 or channels > 64 or \
            not (100 <= rate <= 400000):
        raise LegacyError("unsupported SD2 layout")
    codec, bits = codec_bits
    frames = total // (size * channels)
    info = AudioInfo(rate=rate, channels=channels, frames=frames,
                     container=Container.SD2, codec=codec,
                     bits_per_sample=bits)
    return info, 0, False  # big-endian, data starts at byte 0


def sniff_sd2(path: str) -> bool:
    import os

    if not path.lower().endswith(".sd2"):
        return False
    try:
        parse_sd2(path, os.path.getsize(path))
        return True
    except (LegacyError, OSError):
        return False


def read_sd2_info(path: str) -> AudioInfo:
    import os

    return parse_sd2(path, os.path.getsize(path))[0]


def open_sd2_stream(path: str):
    import os

    info, off, little = parse_sd2(path, os.path.getsize(path))
    return _make_stream(path, info, off, little)


def read_sd2(path: str):
    f, info, off, fb, decode = open_sd2_stream(path)
    with f:
        f.seek(off)
        x = decode(f.read())
    info.frames = x.shape[0]
    return x, info
