"""Apple Core Audio Format (.caf) — native reader and streaming encoder.

Big-endian chunked container; linear-PCM payloads only (the 'lpcm'
format id), int or float, either endianness per the desc flags.  The
'data' chunk may declare size -1 (stream till EOF), which also makes
CAF a natural streaming OUTPUT format.  Reference parity: libsndfile
probe input, original-format output (convolve-file-handler.cc:62-76,
237-251).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from folve_tpu_torch.audio.pcm_stream import PcmStreamEncoderBase
from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class CafError(ValueError):
    pass


_FLAG_FLOAT = 1
_FLAG_LITTLE = 2


def _parse_desc(body: bytes):
    if len(body) < 32:
        raise CafError("short desc chunk")
    rate, fmt_id, flags, bpp, fpp, channels, bits = struct.unpack(
        ">d4sIIIII", body[:32]
    )
    if fmt_id not in (b"lpcm", b"ulaw", b"alaw", b"alac"):
        raise CafError(f"unsupported CAF codec {fmt_id!r}")
    if channels == 0 or rate <= 0 or (bits == 0 and fmt_id != b"alac"):
        raise CafError("bad desc fields")
    del bpp, fpp
    return rate, flags, channels, bits, fmt_id


def _iter_chunks(blob: bytes):
    pos = 8
    while pos + 12 <= len(blob):
        ctype = blob[pos : pos + 4]
        (size,) = struct.unpack(">q", blob[pos + 4 : pos + 12])
        body_off = pos + 12
        if size == -1:  # data till EOF
            size = len(blob) - body_off
        elif size < 0:  # any other negative size: corrupt header
            raise CafError(f"negative chunk size {size}")
        yield ctype, body_off, int(size)
        # body_off > pos always, so the walk strictly advances.
        pos = body_off + int(size)


def _check_magic(blob: bytes) -> None:
    if len(blob) < 8 or blob[:4] != b"caff":
        raise CafError("not a CAF file")


def read_caf(path: str) -> tuple[np.ndarray, AudioInfo]:
    with open(path, "rb") as f:
        blob = f.read()
    _check_magic(blob)
    desc = None
    data = None
    for ctype, off, size in _iter_chunks(blob):
        if ctype == b"desc":
            desc = _parse_desc(blob[off : off + size])
        elif ctype == b"data":
            # First 4 bytes are the edit count.
            data = blob[off + 4 : off + size]
    if desc is None or data is None:
        raise CafError("missing desc/data chunks")
    rate, flags, channels, bits, fmt_id = desc
    if fmt_id == b"alac":
        from folve_tpu_torch.audio.alac import read_caf_alac

        return read_caf_alac(path)
    x, codec = _decode_payload(data, flags, int(bits), int(channels),
                               fmt_id)
    bits_out = 16 if codec in (SampleCodec.ULAW, SampleCodec.ALAW) else int(bits)
    info = AudioInfo(
        rate=int(round(rate)), channels=int(channels), frames=x.shape[0],
        container=Container.CAF, codec=codec, bits_per_sample=bits_out,
    )
    return x, info


def _decode_payload(data: bytes, flags: int, bits: int, channels: int,
                    fmt_id: bytes = b"lpcm"):
    """Raw data bytes (any whole-frame slice) -> (float32 [n, ch], codec).
    Truncated payloads short-decode rather than raising from frombuffer."""
    if fmt_id == b"ulaw":
        from folve_tpu_torch.audio.au import _mulaw_table

        x = _mulaw_table()[np.frombuffer(data, np.uint8)].astype(
            np.float32) / 32768.0
        n = x.size // channels
        return x[: n * channels].reshape(n, channels), SampleCodec.ULAW
    if fmt_id == b"alaw":
        from folve_tpu_torch.audio.au import _alaw_table

        x = _alaw_table()[np.frombuffer(data, np.uint8)].astype(
            np.float32) / 32768.0
        n = x.size // channels
        return x[: n * channels].reshape(n, channels), SampleCodec.ALAW
    is_float = bool(flags & _FLAG_FLOAT)
    endian = "<" if flags & _FLAG_LITTLE else ">"
    elem = max(1, bits // 8)
    data = data[: (len(data) // elem) * elem]
    if is_float and bits == 32:
        x = np.frombuffer(data, endian + "f4").astype(np.float64)
        codec = SampleCodec.FLOAT
    elif is_float and bits == 64:
        x = np.frombuffer(data, endian + "f8")
        codec = SampleCodec.DOUBLE
    elif not is_float and bits == 16:
        x = np.frombuffer(data, endian + "i2").astype(np.float32) / 32768.0
        codec = SampleCodec.PCM_16
    elif not is_float and bits == 24:
        b = np.frombuffer(data[: (len(data) // 3) * 3], np.uint8).reshape(-1, 3)
        if endian == ">":
            v = (
                (b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2]
            )
        else:
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        x = v.astype(np.float32) / float(1 << 23)
        codec = SampleCodec.PCM_24
    elif not is_float and bits == 32:
        x = np.frombuffer(data, endian + "i4").astype(np.float64) / float(1 << 31)
        codec = SampleCodec.PCM_32
    elif not is_float and bits == 8:
        x = np.frombuffer(data, np.int8).astype(np.float32) / 128.0
        codec = SampleCodec.PCM_S8
    else:
        raise CafError(f"unsupported lpcm bits={bits} float={is_float}")
    x = np.asarray(x, np.float32)
    n = x.size // channels
    return x[: n * channels].reshape(n, channels), codec


def open_caf_stream(path: str):
    """(file, info, data_offset, frame_bytes, decode) for a chunked
    source — only the chunk directory is read up front, so a multi-GB
    CAF costs constant memory per open stream."""
    f = open(path, "rb")
    try:
        blob = f.read(1 << 16)
        f.seek(0, 2)
        total = f.tell()
        _check_magic(blob)
        desc = None
        data_off = data_len = None
        pos = 8
        while pos + 12 <= len(blob):
            ctype = blob[pos : pos + 4]
            (size,) = struct.unpack(">q", blob[pos + 4 : pos + 12])
            body_off = pos + 12
            if size < -1:
                raise CafError(f"negative chunk size {size}")
            real = max(0, total - body_off) if size == -1 else int(size)
            if ctype == b"desc":
                desc = _parse_desc(blob[body_off : body_off + real])
            elif ctype == b"data":
                data_off = body_off + 4  # skip the edit count
                data_len = max(0, min(real, total - body_off) - 4)
            if desc is not None and data_len is not None:
                break
            pos = body_off + real
        if desc is None or data_len is None:
            raise CafError("missing desc/data chunks")
        rate, flags, channels, bits, fmt_id = desc
        channels, bits = int(channels), int(bits)
        if fmt_id == b"alac":
            from folve_tpu_torch.audio.alac import AlacSource

            f.seek(0)
            return None, AlacSource(f), data_off, 0, None
        if fmt_id in (b"ulaw", b"alaw"):
            codec = SampleCodec.ULAW if fmt_id == b"ulaw" else SampleCodec.ALAW
            frame_bytes = channels  # one byte stored, 16-bit decoded
            bits_out = 16
        else:
            codec = {
                (True, 32): SampleCodec.FLOAT, (True, 64): SampleCodec.DOUBLE,
                (False, 8): SampleCodec.PCM_S8, (False, 16): SampleCodec.PCM_16,
                (False, 24): SampleCodec.PCM_24, (False, 32): SampleCodec.PCM_32,
            }.get((bool(flags & _FLAG_FLOAT), bits))
            if codec is None:
                raise CafError("unsupported lpcm layout")
            frame_bytes = channels * (bits // 8)
            bits_out = bits
        frames = data_len // max(1, frame_bytes)
        info = AudioInfo(
            rate=int(round(rate)), channels=channels, frames=frames,
            container=Container.CAF, codec=codec, bits_per_sample=bits_out,
        )
    except Exception:
        f.close()
        raise
    return f, info, data_off, frame_bytes, (
        lambda raw: _decode_payload(raw, flags, bits, channels, fmt_id)[0]
    )


def read_caf_info(path: str) -> AudioInfo:
    f, src_or_info, _off, _fb, _dec = open_caf_stream(path)
    if f is None:  # ALAC: ready-made source in slot 1
        info = src_or_info.info
        src_or_info.close()
        return info
    f.close()
    return src_or_info

class CafStreamEncoder(PcmStreamEncoderBase):
    """Streaming CAF encoder: big-endian PCM behind an exact-size
    header; tags ride the standard 'info' chunk."""

    _error = CafError

    def header(self, metadata: Optional[dict] = None) -> bytes:
        bpf = self.channels * self.bits // 8
        desc = struct.pack(
            ">d4sIIIII", float(self.rate), b"lpcm", 0, bpf, 1,
            self.channels, self.bits,
        )
        out = b"caff" + struct.pack(">HH", 1, 0)
        out += b"desc" + struct.pack(">q", len(desc)) + desc
        # Tags ride the standard 'info' chunk (CAFStringsChunk).
        if metadata:
            items = b""
            for k, v in metadata.items():
                items += k.encode() + b"\0" + str(v).encode() + b"\0"
            info = struct.pack(">I", len(metadata)) + items
            out += b"info" + struct.pack(">q", len(info)) + info
        payload = self.total_frames * bpf
        out += b"data" + struct.pack(">q", 4 + payload) + struct.pack(">I", 0)
        return out


def read_caf_metadata(path: str) -> dict:
    """Key/value pairs of the 'info' chunk, if present."""
    try:
        with open(path, "rb") as f:
            blob = f.read(1 << 16)
        _check_magic(blob)
        for ctype, off, size in _iter_chunks(blob):
            if ctype != b"info":
                continue
            body = blob[off : off + size]
            (count,) = struct.unpack(">I", body[:4])
            parts = body[4:].split(b"\0")
            out = {}
            for i in range(0, min(count * 2, len(parts) - 1), 2):
                out[parts[i].decode("utf-8", "replace").upper()] = parts[
                    i + 1
                ].decode("utf-8", "replace")
            return out
    except Exception:
        pass
    return {}


def write_caf(dst, data: np.ndarray, rate: int, bits: int = 16) -> None:
    """Encode float32 [frames, ch] as big-endian PCM CAF."""
    if data.ndim == 1:
        data = data[:, None]
    enc = CafStreamEncoder(rate, data.shape[1], bits, data.shape[0])
    blob = enc.header() + enc.write_float(data)
    if hasattr(dst, "write"):
        dst.write(blob)
    else:
        with open(dst, "wb") as f:
            f.write(blob)
