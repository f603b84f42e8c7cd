"""RIFF/WAVE reader for impulse-response files (numpy only).

The read path the filter loader needs: PCM int16, int24 and int32, IEEE
float32 and float64, plain or ``WAVE_FORMAT_EXTENSIBLE``, in RIFF, RF64
or BW64 framing.  Integer PCM maps to [-1, 1) by dividing by 2^(bits-1),
as libsndfile does, so filter gains match the JAX package's reader
bit for bit.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import BinaryIO, Union

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# GUID remainder (bytes 4..16 of the WAVEX SubFormat) of the ambisonic
# B-format family (reference: zita-audiofile.cc:72-73).
_AMBISONIC_GUID_TAIL = bytes.fromhex("2107d3118644c8c1ca000000")


class WavError(ValueError):
    pass


@dataclasses.dataclass
class WavInfo:
    rate: int
    channels: int
    frames: int
    bits_per_sample: int
    is_float: bool
    ambisonic: bool = False


def _open(src: Union[str, bytes, BinaryIO]) -> BinaryIO:
    if isinstance(src, str):
        return open(src, "rb")
    if isinstance(src, (bytes, bytearray)):
        return io.BytesIO(src)
    return src


def _parse_header(f: BinaryIO):
    riff = f.read(12)
    if len(riff) < 12 or riff[8:12] != b"WAVE" or riff[:4] not in (
        b"RIFF", b"RF64", b"BW64",
    ):
        raise WavError("not a RIFF/WAVE file")
    # RF64/BW64: the 32-bit data size is a 0xFFFFFFFF sentinel and the
    # true 64-bit size lives in a leading ds64 chunk.
    is_rf64 = riff[:4] != b"RIFF"
    ds64_data_size = None
    fmt = None
    data_offset = None
    data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"ds64":
            ds64 = f.read(size)
            if len(ds64) < 16:
                raise WavError("ds64 chunk too short")
            ds64_data_size = struct.unpack("<Q", ds64[8:16])[0]
        elif cid == b"fmt ":
            fmt = f.read(size)
        elif cid == b"data":
            if size == 0xFFFFFFFF and is_rf64:
                if ds64_data_size is None:
                    raise WavError("RF64 data chunk before ds64")
                size = ds64_data_size
            data_offset = f.tell()
            data_size = size
            f.seek(size + (size & 1), io.SEEK_CUR)
            continue
        else:
            f.seek(size + (size & 1), io.SEEK_CUR)
            continue
        if size & 1:
            f.seek(1, io.SEEK_CUR)
    if fmt is None or data_offset is None:
        raise WavError("missing fmt or data chunk")
    # Clamp to the bytes present: recorders write inflated or
    # "unknown length" data sizes.
    file_end = f.seek(0, io.SEEK_END)
    if data_offset + data_size > file_end or (
        data_size == 0xFFFFFFFF and not is_rf64
    ):
        data_size = max(0, file_end - data_offset)
    return _interpret_fmt(fmt, data_size), data_offset, data_size


def _interpret_fmt(fmt: bytes, data_size: int) -> WavInfo:
    if len(fmt) < 16:
        raise WavError("fmt chunk too short")
    tag, channels, rate, _, block_align, bits = struct.unpack("<HHIIHH", fmt[:16])
    ambisonic = False
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 40:
            raise WavError("extensible fmt chunk too short")
        ambisonic = fmt[28:40] == _AMBISONIC_GUID_TAIL
        tag = struct.unpack("<H", fmt[24:26])[0]
    if channels == 0 or block_align == 0:
        raise WavError("bad channel count or block alignment")
    if tag == _WAVE_FORMAT_PCM and bits in (16, 24, 32):
        is_float = False
    elif tag == _WAVE_FORMAT_IEEE_FLOAT and bits in (32, 64):
        is_float = True
    else:
        raise WavError(f"unsupported WAVE format tag 0x{tag:04x}, {bits} bits")
    frames = data_size // (channels * (bits // 8))
    return WavInfo(rate=rate, channels=channels, frames=frames,
                   bits_per_sample=bits, is_float=is_float,
                   ambisonic=ambisonic)


def _decode_pcm(raw: bytes, info: WavInfo) -> np.ndarray:
    ch = info.channels
    bits = info.bits_per_sample
    width = bits // 8
    raw = raw[: len(raw) - len(raw) % width]
    if info.is_float:
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        x = x.astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = (val << 8) >> 8  # sign-extend 24 -> 32
        x = val.astype(np.float32) / 8388608.0
    else:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    n = (len(x) // ch) * ch
    return x[:n].reshape(-1, ch)


def read_wav(src) -> tuple[np.ndarray, WavInfo]:
    """Decode a whole WAV file -> (float32 [frames, channels], WavInfo)."""
    f = _open(src)
    try:
        info, offset, size = _parse_header(f)
        f.seek(offset)
        raw = f.read(size)
    finally:
        if isinstance(src, str):
            f.close()
    return _decode_pcm(raw, info), info
