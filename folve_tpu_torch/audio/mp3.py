"""MPEG-1 Layer III (MP3) decoding via the in-repo native decoder.

The reference convolves MP3 whenever its libsndfile links mpg123
(probe at convolve-file-handler.cc:62-76).  Here the decoder is from
scratch — ``native/mp3_codec.cc`` implements sync/headers, the bit
reservoir, scalefactors, Huffman spectrum, requantization, stereo
modes, the hybrid IMDCT filterbank and the polyphase synthesis per the
public ISO/IEC 11172-3 specification; no third-party codec library is
involved.  ID3v2/ID3v1 tags are parsed here for the output-header tag
carryover (the reference gets them via sf_get_string).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec
from folve_tpu_torch.utils.native_build import load_native


class Mp3Error(ValueError):
    pass


class _FolveMp3Info(ctypes.Structure):
    _fields_ = [
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("frames", ctypes.c_int64),
    ]


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load_native()
        lib.folve_mp3_open.restype = ctypes.c_void_p
        lib.folve_mp3_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.folve_mp3_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_FolveMp3Info)
        ]
        lib.folve_mp3_read.restype = ctypes.c_int64
        lib.folve_mp3_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64
        ]
        lib.folve_mp3_rewind.restype = ctypes.c_int
        lib.folve_mp3_rewind.argtypes = [ctypes.c_void_p]
        lib.folve_mp3_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


_BITRATES = {
    # (is_mpeg1, layer): kbps per bitrate index
    (True, 1): [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384,
                416, 448, 0],
    (True, 2): [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                320, 384, 0],
    (True, 3): [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                256, 320, 0],
    (False, 1): [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192,
                 224, 256, 0],
    (False, 2): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
                 160, 0],
    (False, 3): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
                 160, 0],
}
_MPEG1_RATE = [44100, 48000, 32000, 0]


def _frame_len(head: bytes, pos: int) -> int:
    """Byte length of an MPEG audio frame header at pos, or 0."""
    if pos + 4 > len(head):
        return 0
    b = head[pos : pos + 4]
    if b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
        return 0
    version = (b[1] >> 3) & 3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    layer = 4 - ((b[1] >> 1) & 3)  # -> 1, 2, 3
    br_idx = (b[2] >> 4) & 0xF
    sr_idx = (b[2] >> 2) & 3
    pad = (b[2] >> 1) & 1
    if version == 1 or layer == 4 or br_idx in (0, 15) or sr_idx == 3:
        return 0
    rate = _MPEG1_RATE[sr_idx]
    if version == 2:
        rate //= 2
    elif version == 0:
        rate //= 4
    kbps = _BITRATES[(version == 3, layer)][br_idx]
    if layer == 1:
        return (12 * kbps * 1000 // rate + pad) * 4
    if layer == 3 and version != 3:  # Layer III LSF: 576-sample frames
        return 72 * kbps * 1000 // rate + pad
    return 144 * kbps * 1000 // rate + pad


def sniff_mp3(path: str) -> bool:
    """True if the file starts like MPEG audio: an ID3v2 tag, or a
    valid frame header CHAINED to a second valid header (a lone sync
    pattern matches arbitrary binary data far too often).  Called LAST
    in container sniffing — every other container's magic wins."""
    try:
        with open(path, "rb") as f:
            head = f.read(1 << 16)
    except OSError:
        return False
    if head[:3] == b"ID3":
        return True  # ID3 implies an MPEG audio file in practice
    for pos in range(min(len(head), 8192)):
        n = _frame_len(head, pos)
        if not n:
            continue
        nxt = pos + n
        if nxt + 4 > len(head) or _frame_len(head, nxt):
            return True
    return False


class Mp3Source:
    """Streaming MP3 decode source (AudioSource protocol).

    Accepts a path or raw MPEG bitstream bytes; ``container`` lets a
    wrapping container (MPEG-in-WAV, fmt tags 0x50/0x55 — what
    libsndfile 1.1 decodes for the reference) report itself."""

    def __init__(self, path_or_bytes, container: Container = Container.MP3):
        lib = _get_lib()
        self._lib = lib
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        self._h = lib.folve_mp3_open(data, len(data))
        if not self._h:
            raise Mp3Error("cannot open mp3 stream")
        info = _FolveMp3Info()
        lib.folve_mp3_info(self._h, ctypes.byref(info))
        if info.channels == 0 or info.rate == 0:
            lib.folve_mp3_close(self._h)
            self._h = None
            raise Mp3Error("no mp3 stream info")
        self.info = AudioInfo(
            rate=int(info.rate),
            channels=int(info.channels),
            frames=max(0, int(info.frames)),
            container=container,
            codec=SampleCodec.MP3,
            bits_per_sample=16,  # nominal: mp3 is float internally
        )

    def read_float(self, nframes: int) -> np.ndarray:
        ch = self.info.channels
        out = np.empty((nframes, ch), dtype=np.float32)
        n = self._lib.folve_mp3_read(self._h, out.ctypes.data, nframes)
        if n < 0:
            raise Mp3Error("mp3 decode error")
        return out[:n]

    def rewind(self) -> None:
        if self._lib.folve_mp3_rewind(self._h) != 0:
            raise Mp3Error("rewind failed")

    def close(self) -> None:
        if self._h:
            self._lib.folve_mp3_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_mp3(path: str) -> tuple[np.ndarray, AudioInfo]:
    from folve_tpu_torch.audio.source import drain_source

    return drain_source(Mp3Source(path))


def read_mp3_info(path: str) -> AudioInfo:
    src = Mp3Source(path)
    info = src.info
    src.close()
    return info


# ID3v2 text-frame ids -> vorbis-style tag names (ID3v2.3/2.4).
_ID3_FRAMES = {
    b"TIT2": "TITLE",
    b"TPE1": "ARTIST",
    b"TALB": "ALBUM",
    b"TDRC": "DATE",
    b"TYER": "DATE",
    b"TRCK": "TRACKNUMBER",
    b"TCON": "GENRE",
    b"COMM": "COMMENT",
}


def _decode_id3_text(raw: bytes) -> str:
    if not raw:
        return ""
    enc, body = raw[0], raw[1:]
    try:
        if enc == 0:
            return body.decode("latin-1", "replace").rstrip("\0")
        if enc == 1:
            return body.decode("utf-16", "replace").rstrip("\0")
        if enc == 2:
            return body.decode("utf-16-be", "replace").rstrip("\0")
        return body.decode("utf-8", "replace").rstrip("\0")
    except Exception:
        return ""


def read_mp3_metadata(path: str) -> dict:
    """String tags from ID3v2 (preferred) or ID3v1."""
    out = {}
    try:
        with open(path, "rb") as f:
            head = f.read(10)
            if head[:3] == b"ID3" and len(head) == 10:
                size = ((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14) | \
                       ((head[8] & 0x7F) << 7) | (head[9] & 0x7F)
                version = head[3]
                body = f.read(min(size, 1 << 20))
                pos = 0
                while pos + 10 <= len(body):
                    if version >= 3:
                        fid = body[pos : pos + 4]
                        (flen,) = struct.unpack(">I", body[pos + 4 : pos + 8])
                        if version >= 4:  # syncsafe frame sizes
                            b = body[pos + 4 : pos + 8]
                            flen = ((b[0] & 0x7F) << 21) | ((b[1] & 0x7F) << 14) | \
                                   ((b[2] & 0x7F) << 7) | (b[3] & 0x7F)
                        hlen = 10
                    else:  # ID3v2.2: 3-byte ids and sizes
                        fid = body[pos : pos + 3] + b" "
                        flen = (body[pos + 3] << 16) | (body[pos + 4] << 8) | \
                               body[pos + 5]
                        hlen = 6
                    if not fid.strip() or flen <= 0:
                        break
                    name = _ID3_FRAMES.get(fid)
                    if name and name not in out:
                        raw = body[pos + hlen : pos + hlen + flen]
                        if fid == b"COMM" and len(raw) > 4:
                            raw = raw[:1] + raw[4:].split(b"\0", 1)[-1]
                        val = _decode_id3_text(raw)
                        if val:
                            out[name] = val
                    pos += hlen + flen
            if not out:  # ID3v1 fallback (last 128 bytes)
                f.seek(0, os.SEEK_END)
                end = f.tell()
                if end >= 128:
                    f.seek(end - 128)
                    tag = f.read(128)
                    if tag[:3] == b"TAG":
                        def s(a, b):
                            return tag[a:b].split(b"\0")[0].decode(
                                "latin-1", "replace").strip()
                        for k, v in (("TITLE", s(3, 33)),
                                     ("ARTIST", s(33, 63)),
                                     ("ALBUM", s(63, 93)),
                                     ("DATE", s(93, 97)),
                                     ("COMMENT", s(97, 127))):
                            if v:
                                out[k] = v
    except Exception:
        pass
    return out
