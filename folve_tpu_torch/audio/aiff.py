"""AIFF / AIFF-C codec (numpy, no external libraries).

Covers the reference's libsndfile AIFF read path (zita-audiofile.cc /
convolve-file-handler probing): big-endian PCM 8/16/24/32, plus AIFC
float32 ('fl32'/'FL32') and little-endian ('sowt') variants.  The
80-bit extended-float sample rate of the COMM chunk is decoded exactly.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Union

import numpy as np

from folve_tpu_torch.audio.pcm_stream import PcmStreamEncoderBase
from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class AiffError(ValueError):
    pass


def _open(src: Union[str, bytes, BinaryIO]) -> BinaryIO:
    if isinstance(src, str):
        return open(src, "rb")
    if isinstance(src, (bytes, bytearray)):
        return io.BytesIO(src)
    return src


def _decode_extended(b: bytes) -> float:
    """80-bit IEEE 754 extended float (the COMM sample rate field)."""
    if len(b) != 10:
        raise AiffError("bad extended float")
    sign_exp = struct.unpack(">H", b[:2])[0]
    mantissa = struct.unpack(">Q", b[2:])[0]
    sign = -1.0 if sign_exp & 0x8000 else 1.0
    exp = sign_exp & 0x7FFF
    if exp == 0 and mantissa == 0:
        return 0.0
    if exp >= 16383 + 64:  # inf/NaN encodings and absurd magnitudes
        raise AiffError("bad extended-float sample rate")
    return sign * mantissa * 2.0 ** (exp - 16383 - 63)


def _parse(f: BinaryIO):
    form = f.read(12)
    if len(form) < 12 or form[:4] != b"FORM" or form[8:12] not in (b"AIFF", b"AIFC"):
        raise AiffError("not an AIFF file")
    is_aifc = form[8:12] == b"AIFC"
    channels = rate = bits = frames = None
    compression = b"NONE"
    sound_offset = sound_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack(">I", hdr[4:])[0]
        if cid == b"COMM":
            body = f.read(size)
            if len(body) < 18:
                raise AiffError("truncated COMM chunk")
            channels, nframes, bits = struct.unpack(">HIH", body[:8])
            rate = int(round(_decode_extended(body[8:18])))
            frames = nframes
            if is_aifc and len(body) >= 22:
                compression = body[18:22]
        elif cid == b"SSND":
            ssnd_hdr = f.read(8)
            if len(ssnd_hdr) < 8:
                raise AiffError("truncated SSND chunk")
            off, _block = struct.unpack(">II", ssnd_hdr)
            sound_offset = f.tell() + off
            sound_size = size - 8 - off
            f.seek(size - 8 + (size & 1), io.SEEK_CUR)
            continue
        else:
            f.seek(size + (size & 1), io.SEEK_CUR)
            continue
        if size & 1:
            f.seek(1, io.SEEK_CUR)
    if channels is None or sound_offset is None:
        raise AiffError("missing COMM or SSND chunk")
    if rate is None or rate <= 0 or channels == 0:
        raise AiffError("bad COMM rate or channel count")
    # Clamp the declared SSND size to the bytes actually present (the
    # WAV parser does the same): a truncated SSND must short-decode AND
    # report the short length, or exact-size output headers over-promise.
    # The frame clamp itself happens AFTER codec dispatch below — the
    # storage width differs from the declared sampleSize for compressed
    # AIFC (e.g. QuickTime writes sampleSize=16 for ulaw, stored 1
    # byte/sample; clamping by 16-bit width would halve the count).
    try:
        file_end = f.seek(0, io.SEEK_END)
        sound_size = max(0, min(sound_size, file_end - sound_offset))
    except OSError:
        pass
    comp = compression.lower()
    if comp == b"twos":  # QuickTime alias for big-endian PCM
        comp = b"none"
    block_align = samples_per_block = 0
    if comp in (b"none", b"sowt"):
        codec = {8: SampleCodec.PCM_S8, 16: SampleCodec.PCM_16,
                 24: SampleCodec.PCM_24, 32: SampleCodec.PCM_32}.get(bits)
    elif comp == b"fl32":
        codec = SampleCodec.FLOAT
    elif comp == b"fl64":
        codec = SampleCodec.DOUBLE
        bits = 64
    elif comp == b"ulaw":
        codec = SampleCodec.ULAW
        bits = 16  # G.711 decodes to 16-bit range; storage is 1 byte
    elif comp == b"alaw":
        codec = SampleCodec.ALAW
        bits = 16
    elif comp == b"raw ":
        codec = SampleCodec.PCM_U8
        bits = 8
    elif comp == b"gsm ":
        # GSM 6.10 in AIFC: plain 33-byte/160-sample frames (no WAV49
        # block pairing).  Stateful across frames -> streaming happens
        # via GsmSource, not the chunked PCM path.
        if channels != 1:
            raise AiffError("GSM 6.10 is mono-only")
        codec = SampleCodec.GSM610
        bits = 16
        block_align = 33
        samples_per_block = 160
        frames = min(frames, (sound_size // 33) * 160)
    elif comp == b"dwvw":
        # TX16W Delta Word Variable Width at the COMM-declared depth
        # (12/16/24).  One continuous bitstream, no framing: the COMM
        # frame count is the only source of truth for the length (the
        # payload size only bounds it — each sample costs >= 1 bit).
        if channels != 1:
            raise AiffError("DWVW is mono-only")
        if bits not in (12, 16, 24):
            raise AiffError(f"unsupported DWVW depth {bits}")
        codec = SampleCodec.DWVW
        frames = min(frames, sound_size * 8)
    elif comp == b"ima4":
        # Apple/QT IMA: 34-byte chunks of 64 samples per channel,
        # channel chunks interleaved; each chunk carries its own
        # predictor state.  The COMM frame count is unreliable here
        # (libsndfile ignores it too) — the chunk count is the truth.
        codec = SampleCodec.IMA_ADPCM
        bits = 16
        block_align = 34 * channels
        samples_per_block = 64
        frames = (sound_size // block_align) * 64
    else:
        raise AiffError(f"unsupported AIFC compression {compression!r}")
    if codec is None:
        raise AiffError(f"unsupported AIFF bit depth {bits}")
    if comp in (b"ulaw", b"alaw", b"raw "):
        frames = min(frames, sound_size // channels)
    elif comp == b"fl64":
        frames = min(frames, sound_size // (8 * channels))
    elif comp not in (b"ima4", b"gsm ", b"dwvw") and bits and channels:
        frames = min(frames, sound_size // max(1, channels * (bits // 8)))
    info = AudioInfo(
        rate=rate,
        channels=channels,
        frames=frames,
        container=Container.AIFF,
        codec=codec,
        bits_per_sample=bits,
        block_align=block_align,
        samples_per_block=samples_per_block,
    )
    return info, sound_offset, sound_size, comp


def _decode_payload(raw: bytes, info: AudioInfo, little: bool) -> np.ndarray:
    """Raw SSND bytes (any whole-frame slice) -> float32 [n, ch]."""
    ch = info.channels
    c = info.codec
    if c == SampleCodec.PCM_16:
        raw = raw[: len(raw) - len(raw) % 2]
        x = np.frombuffer(raw, dtype="<i2" if little else ">i2").astype(np.float32) / 32768.0
    elif c == SampleCodec.PCM_S8:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif c == SampleCodec.PCM_24:
        b = np.frombuffer(raw[: len(raw) - len(raw) % 3], dtype=np.uint8).reshape(-1, 3)
        if little:
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
        else:
            val = (
                (b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2].astype(np.int32)
            )
        val = (val << 8) >> 8
        x = val.astype(np.float32) / 8388608.0
    elif c == SampleCodec.PCM_32:
        raw = raw[: len(raw) - len(raw) % 4]
        x = np.frombuffer(raw, dtype="<i4" if little else ">i4").astype(np.float32) / 2147483648.0
    elif c == SampleCodec.FLOAT:
        raw = raw[: len(raw) - len(raw) % 4]
        x = np.frombuffer(raw, dtype="<f4" if little else ">f4").astype(np.float32)
    elif c == SampleCodec.DOUBLE:
        raw = raw[: len(raw) - len(raw) % 8]
        x = np.frombuffer(raw, dtype="<f8" if little else ">f8").astype(np.float32)
    elif c == SampleCodec.PCM_U8:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif c == SampleCodec.ULAW:
        from folve_tpu_torch.audio.au import _mulaw_table

        x = _mulaw_table()[np.frombuffer(raw, np.uint8)].astype(np.float32) / 32768.0
    elif c == SampleCodec.ALAW:
        from folve_tpu_torch.audio.au import _alaw_table

        x = _alaw_table()[np.frombuffer(raw, np.uint8)].astype(np.float32) / 32768.0
    elif c == SampleCodec.IMA_ADPCM:
        return _decode_ima4(raw, ch)
    elif c == SampleCodec.GSM610:
        from folve_tpu_torch.audio.gsm import decode_gsm

        return decode_gsm(raw, wav49=False)
    elif c == SampleCodec.DWVW:
        from folve_tpu_torch.audio.dwvw import decode_dwvw

        return decode_dwvw(raw, info.bits_per_sample,
                           max_frames=info.frames)
    else:
        raise AiffError(f"cannot decode {c}")
    n = (len(x) // ch) * ch
    return x[:n].reshape(-1, ch)


def _decode_ima4(raw: bytes, channels: int) -> np.ndarray:
    """Apple/QT 'ima4' chunks -> float32 [n, ch].  Chunks are
    independent (each carries predictor state in its 2-byte preamble),
    so the sequential loop runs over the 64 in-chunk samples with all
    chunks decoded as one vector step."""
    from folve_tpu_torch.audio.wav import _IMA_INDEX_TABLE, _IMA_STEP_TABLE

    cb = 34 * channels
    nb = len(raw) // cb
    raw = raw[: nb * cb]
    if nb == 0:
        return np.zeros((0, channels), np.float32)
    blocks = np.frombuffer(raw, np.uint8).reshape(nb * channels, 34)
    pre = (blocks[:, 0].astype(np.int32) << 8) | blocks[:, 1]
    pred = pre & 0xFF80
    pred = np.where(pred >= 32768, pred - 65536, pred)
    index = np.clip(pre & 0x7F, 0, 88)
    data = blocks[:, 2:]
    nibs = np.empty((blocks.shape[0], 64), np.uint8)
    nibs[:, 0::2] = data & 0x0F  # low nibble first
    nibs[:, 1::2] = data >> 4
    out = np.empty((blocks.shape[0], 64), np.int32)
    for s in range(64):
        nib = nibs[:, s].astype(np.int32)
        step = _IMA_STEP_TABLE[index]
        diff = step >> 3
        diff = diff + np.where(nib & 4, step, 0)
        diff = diff + np.where(nib & 2, step >> 1, 0)
        diff = diff + np.where(nib & 1, step >> 2, 0)
        pred = np.where(nib & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        index = np.clip(index + _IMA_INDEX_TABLE[nib], 0, 88)
        out[:, s] = pred
    x = out.reshape(nb, channels, 64).transpose(0, 2, 1).reshape(-1, channels)
    return x.astype(np.float32) / 32768.0


def read_aiff(src) -> tuple[np.ndarray, AudioInfo]:
    f = _open(src)
    info, offset, size, comp = _parse(f)
    f.seek(offset)
    raw = f.read(max(0, size))  # short read on truncated files is fine
    x = _decode_payload(raw, info, comp == b"sowt")
    if comp == b"gsm " and x.shape[0] > info.frames:
        # A partial tail block decodes blockwise (160-sample ceil); the
        # COMM frame count is authoritative in AIFC (unlike WAV, where
        # libsndfile ignores the fact chunk — probed in test_gsm.py).
        x = x[: info.frames]
    return x, info


def open_aiff_stream(path: str):
    """(file, info, data_offset, frame_bytes, decode) for a chunked
    source — constant memory per open stream, like the reference's
    libsndfile streaming reads (sound-processor.cc:76-84).  For 'ima4'
    the returned object is a ready-made block-granular BlockSource
    instead (first tuple element None)."""
    f = open(path, "rb")
    try:
        info, offset, _size, comp = _parse(f)
    except Exception:
        f.close()
        raise
    if info.codec == SampleCodec.IMA_ADPCM:
        from folve_tpu_torch.audio.source import BlockSource

        src = BlockSource(f, info, offset, 34 * info.channels, 64,
                          lambda raw: _decode_ima4(raw, info.channels))
        return None, src, offset, 0, None
    if info.codec == SampleCodec.GSM610:
        from folve_tpu_torch.audio.gsm import GsmSource

        return None, GsmSource(f, info, offset, _size, wav49=False), offset, 0, None
    if info.codec == SampleCodec.DWVW:
        from folve_tpu_torch.audio.dwvw import DwvwSource

        return None, DwvwSource(f, info, offset, _size), offset, 0, None
    little = comp == b"sowt"
    storage = {
        SampleCodec.ULAW: 1, SampleCodec.ALAW: 1, SampleCodec.PCM_U8: 1,
        SampleCodec.DOUBLE: 8,
    }.get(info.codec, info.bits_per_sample // 8)
    frame_bytes = info.channels * storage
    return f, info, offset, frame_bytes, (
        lambda raw: _decode_payload(raw, info, little)
    )


def read_aiff_info(src) -> AudioInfo:
    info, _, _, _ = _parse(_open(src))
    return info


# AIFF text chunks <-> vorbis-style tag names (libsndfile's mapping; the
# reference carries these via sf_get_string/sf_set_string,
# convolve-file-handler.cc:484-495).
_TEXT_CHUNKS = {
    b"NAME": "TITLE",
    b"AUTH": "ARTIST",
    b"(c) ": "COPYRIGHT",
    b"ANNO": "COMMENT",
}
_TAG_CHUNKS = {v: k for k, v in _TEXT_CHUNKS.items()}


def read_aiff_metadata(src) -> dict:
    """String tags from NAME/AUTH/(c)/ANNO chunks, vorbis-style keys."""
    f = _open(src)
    out = {}
    form = f.read(12)
    if len(form) < 12 or form[:4] != b"FORM" or form[8:12] not in (b"AIFF", b"AIFC"):
        return out
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack(">I", hdr[4:])[0]
        name = _TEXT_CHUNKS.get(cid)
        if name:
            val = f.read(size).split(b"\0")[0]
            if val:
                out[name] = val.decode("utf-8", errors="replace")
            if size & 1:
                f.seek(1, io.SEEK_CUR)
        else:
            f.seek(size + (size & 1), io.SEEK_CUR)
    return out


class AiffStreamEncoder(PcmStreamEncoderBase):
    """Streaming AIFF encoder: big-endian PCM behind an exact-size
    header (sound-processor.cc writes what it reads, so frame counts
    are known up front)."""

    _allowed_bits = (16, 24, 32)
    _error = AiffError

    def header(self, metadata=None) -> bytes:
        if self.rate <= 0:
            raise AiffError(f"bad sample rate {self.rate}")
        mant, exp = self.rate, 16383 + 63
        while mant < (1 << 63):
            mant <<= 1
            exp -= 1
        ext = struct.pack(">HQ", exp, mant)
        comm = struct.pack(">HIH", self.channels, self.total_frames, self.bits) + ext
        # Carry string tags over as NAME/AUTH/(c)/ANNO text chunks
        # (reference: sf_set_string copy, convolve-file-handler.cc:484-495).
        text = b""
        for name, value in (metadata or {}).items():
            cid = _TAG_CHUNKS.get(name.upper())
            if cid is None:
                continue
            payload = value.encode("utf-8")
            text += cid + struct.pack(">I", len(payload)) + payload
            if len(payload) & 1:
                text += b"\0"
        payload_len = self.total_frames * self.channels * self.bits // 8
        ssnd_len = 8 + payload_len
        body_len = 4 + len(text) + 8 + len(comm) + 8 + ssnd_len
        out = b"FORM" + struct.pack(">I", body_len) + b"AIFF"
        out += text
        out += b"COMM" + struct.pack(">I", len(comm)) + comm
        out += b"SSND" + struct.pack(">I", ssnd_len) + struct.pack(">II", 0, 0)
        return out


def write_aiff(dst, data: np.ndarray, rate: int, bits: int = 16) -> None:
    """Encode float32 [frames, ch] as big-endian PCM AIFF."""
    if data.ndim == 1:
        data = data[:, None]
    frames, ch = data.shape
    if bits == 16:
        payload = np.clip(np.round(data * 32768.0), -32768, 32767).astype(">i2").tobytes()
    elif bits == 24:
        v = np.clip(np.round(data * 8388608.0), -8388608, 8388607).astype(np.int32).reshape(-1)
        out = np.empty((v.size, 3), dtype=np.uint8)
        out[:, 0] = (v >> 16) & 0xFF
        out[:, 1] = (v >> 8) & 0xFF
        out[:, 2] = v & 0xFF
        payload = out.tobytes()
    elif bits == 32:
        payload = np.clip(
            np.round(data * 2147483648.0), -2147483648, 2147483647
        ).astype(">i4").tobytes()
    else:
        raise AiffError(f"unsupported AIFF write depth {bits}")
    # 80-bit extended sample rate.
    if rate <= 0:
        raise AiffError(f"bad sample rate {rate}")
    mant = rate
    exp = 16383 + 63
    while mant < (1 << 63):
        mant <<= 1
        exp -= 1
    ext = struct.pack(">HQ", exp, mant)
    comm = struct.pack(">HIH", ch, frames, bits) + ext
    ssnd = struct.pack(">II", 0, 0) + payload
    body = b"AIFF"
    body += b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd + (b"\0" if len(ssnd) & 1 else b"")
    blob = b"FORM" + struct.pack(">I", len(body)) + body
    if isinstance(dst, str):
        with open(dst, "wb") as f:
            f.write(blob)
    else:
        dst.write(blob)
