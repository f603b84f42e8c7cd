"""FLAC decode/encode — ctypes bindings over the native codec.

The heavy lifting lives in native/flac_codec.cc (C++, no third-party
libraries); this module provides numpy-facing wrappers plus the
float<->PCM conventions matching the WAV codec (and libsndfile, which
the reference uses: sf_readf_float divides by 2^(bits-1)).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Union

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec
from folve_tpu_torch.utils.native_build import load_native


class FlacError(ValueError):
    pass


class _FolveFlacInfo(ctypes.Structure):
    _fields_ = [
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits", ctypes.c_uint32),
        ("frames", ctypes.c_uint64),
        ("min_blocksize", ctypes.c_uint32),
        ("max_blocksize", ctypes.c_uint32),
        ("md5", ctypes.c_uint8 * 16),
    ]


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load_native()
        lib.folve_flac_open.restype = ctypes.c_void_p
        lib.folve_flac_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.folve_flac_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(_FolveFlacInfo)]
        lib.folve_flac_read.restype = ctypes.c_int64
        lib.folve_flac_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.folve_flac_rewind.argtypes = [ctypes.c_void_p]
        lib.folve_flac_close.argtypes = [ctypes.c_void_p]
        lib.folve_flac_enc_new.restype = ctypes.c_void_p
        lib.folve_flac_enc_new.argtypes = [ctypes.c_uint32] * 4 + [ctypes.c_uint64]
        for fn in ("folve_flac_enc_header", "folve_flac_enc_finish"):
            getattr(lib, fn).restype = ctypes.c_uint64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.folve_flac_enc_write.restype = ctypes.c_uint64
        lib.folve_flac_enc_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.folve_flac_enc_streaminfo.restype = ctypes.c_uint64
        lib.folve_flac_enc_streaminfo.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.folve_flac_enc_copy.argtypes = [ctypes.c_void_p]
        lib.folve_flac_enc_free.argtypes = [ctypes.c_void_p]
        lib.folve_flac_enc_set_md5.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.folve_flac_enc_set_threads.argtypes = [ctypes.c_int]
        lib.folve_flac_enc_get_threads.restype = ctypes.c_int
        lib.folve_flac_enc_last_width.restype = ctypes.c_int
        lib.folve_flac_enc_frame_count.restype = ctypes.c_uint64
        lib.folve_flac_enc_frame_count.argtypes = [ctypes.c_void_p]
        lib.folve_flac_enc_frame_offset.restype = ctypes.c_uint64
        lib.folve_flac_enc_frame_offset.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64
        ]
        _lib = lib
    return _lib


def set_encoder_threads(n: int) -> None:
    """Process-wide parallel codec worker count (0 = auto:
    hardware_concurrency capped at 8; 1 = serial).  The pool serves
    FLAC frame ENCODE (multi-block writes), FLAC frame DECODE
    (multi-frame reads) and Ogg Vorbis packet decode.  Output is
    identical at any setting — frames
    are independent, counters fold in frame order, and the decoder
    falls back to the serial path on any scan/CRC anomaly."""
    _get_lib().folve_flac_enc_set_threads(int(n))


def get_encoder_threads() -> int:
    return int(_get_lib().folve_flac_enc_get_threads())


def last_parallel_width() -> int:
    """Test probe: distinct threads that encoded during the last pooled
    batch (0 if the last write ran serially)."""
    return int(_get_lib().folve_flac_enc_last_width())


def _fetch(lib, nbytes: int) -> bytes:
    buf = ctypes.create_string_buffer(nbytes)
    lib.folve_flac_enc_copy(buf)
    return buf.raw


def _info_from_struct(st: _FolveFlacInfo) -> AudioInfo:
    return AudioInfo(
        rate=st.rate,
        channels=st.channels,
        frames=st.frames,
        container=Container.FLAC,
        codec=SampleCodec.FLAC,
        bits_per_sample=st.bits,
    )


class FlacDecoder:
    """Streaming FLAC decoder over an in-memory byte buffer."""

    def __init__(self, data: Union[bytes, bytearray, str]):
        if isinstance(data, str):
            with open(data, "rb") as f:
                data = f.read()
        self._lib = _get_lib()
        data = bytes(data)
        # folve_flac_open copies into the native decoder; retaining the
        # Python buffer too would pin 2x the file per open stream.
        self._handle = self._lib.folve_flac_open(data, len(data))
        if not self._handle:
            raise FlacError("invalid FLAC stream")
        st = _FolveFlacInfo()
        self._lib.folve_flac_info(self._handle, ctypes.byref(st))
        self.info = _info_from_struct(st)
        self._scale = float(1 << (self.info.bits_per_sample - 1))

    def read_int(self, nframes: int) -> np.ndarray:
        """Decode up to nframes -> int32 [n, channels] (native bit depth)."""
        ch = self.info.channels
        out = np.empty((nframes, ch), dtype=np.int32)
        got = self._lib.folve_flac_read(
            self._handle, out.ctypes.data_as(ctypes.c_void_p), nframes
        )
        return out[:got]

    def read_float(self, nframes: int) -> np.ndarray:
        """Decode up to nframes -> float32 [n, channels] in [-1, 1)."""
        # One fused convert+scale pass (astype then divide made two).
        return np.multiply(
            self.read_int(nframes), np.float32(1.0 / self._scale),
            dtype=np.float32,
        )

    def rewind(self):
        self._lib.folve_flac_rewind(self._handle)

    def close(self):
        if self._handle:
            self._lib.folve_flac_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FlacEncoder:
    """Streaming FLAC encoder with fixed block size.

    Mirrors the piecewise output model the reference builds on libsndfile
    virtual IO (conversion-buffer.cc:60-98): ``header()`` first, then
    ``write()`` chunks, ``finish()`` flushes, and ``streaminfo()``
    returns the up-to-date 34-byte STREAMINFO for header patching.
    """

    STREAMINFO_FILE_OFFSET = 8  # after 'fLaC' magic + 4-byte block header

    def __init__(
        self,
        rate: int,
        channels: int,
        bits: int = 16,
        blocksize: int = 4096,
        total_frames_hint: int = 0,
        md5: bool = True,
    ):
        if bits not in (8, 16, 24):
            raise FlacError(f"unsupported FLAC encode bit depth {bits}")
        self._lib = _get_lib()
        self._handle = self._lib.folve_flac_enc_new(
            rate, channels, bits, blocksize, total_frames_hint
        )
        if not md5:
            # Serving redacts the header MD5 field (the full-stream
            # digest cannot be known up front,
            # convolve-file-handler.cc:449-457), so the per-write MD5
            # pass is skipped there.
            self._lib.folve_flac_enc_set_md5(self._handle, 0)
        self.rate = rate
        self.channels = channels
        self.bits = bits
        self.blocksize = blocksize
        self._scale = float(1 << (bits - 1))
        self._limit = (1 << (bits - 1)) - 1

    def header(self, metadata: Optional[dict] = None) -> bytes:
        """fLaC magic + STREAMINFO (+ VORBIS_COMMENT tags + padding).

        ``metadata``: optional {FIELD: value} carried over from the
        source file (the reference's sf string copy,
        convolve-file-handler.cc:484-495)."""
        n = self._lib.folve_flac_enc_header(self._handle)
        raw = _fetch(self._lib, n)
        if not metadata:
            return raw
        # raw = magic(4) + streaminfo block(4+34) + padding block(last).
        streaminfo = bytearray(raw[4:42])
        streaminfo[0] &= 0x7F  # clear last-block in case
        padding = bytearray(raw[42:])
        vendor = b"folve-tpu"
        comments = bytearray()
        comments += len(vendor).to_bytes(4, "little") + vendor
        items = [f"{k}={v}".encode("utf-8") for k, v in metadata.items()]
        comments += len(items).to_bytes(4, "little")
        for item in items:
            comments += len(item).to_bytes(4, "little") + item
        vc_block = bytes([0x04]) + len(comments).to_bytes(3, "big") + bytes(comments)
        return b"fLaC" + bytes(streaminfo) + vc_block + bytes(padding)

    def write_int(self, samples: np.ndarray) -> bytes:
        x = np.ascontiguousarray(samples, dtype=np.int32)
        if x.ndim != 2 or x.shape[1] != self.channels:
            raise FlacError(f"expected [n, {self.channels}] samples")
        n = self._lib.folve_flac_enc_write(
            self._handle, x.ctypes.data_as(ctypes.c_void_p), x.shape[0]
        )
        return _fetch(self._lib, n)

    def write_float(self, samples: np.ndarray) -> bytes:
        """float [-1,1) -> PCM with libsndfile-compatible scale+clip."""
        v = np.clip(
            np.round(np.asarray(samples, dtype=np.float64) * self._scale),
            -self._scale,
            self._limit,
        ).astype(np.int32)
        return self.write_int(v)

    def finish(self) -> bytes:
        n = self._lib.folve_flac_enc_finish(self._handle)
        return _fetch(self._lib, n)

    def streaminfo(self, with_md5: bool = True) -> bytes:
        n = self._lib.folve_flac_enc_streaminfo(self._handle, 1 if with_md5 else 0)
        return _fetch(self._lib, n)

    def frame_count(self) -> int:
        """Frames emitted so far (for SEEKTABLE regeneration)."""
        return int(self._lib.folve_flac_enc_frame_count(self._handle))

    def frame_offset(self, i: int) -> int:
        """Byte offset of frame i relative to the first audio byte."""
        return int(self._lib.folve_flac_enc_frame_offset(self._handle, i))

    def close(self):
        if self._handle:
            self._lib.folve_flac_enc_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_flac(src) -> tuple[np.ndarray, AudioInfo]:
    """Decode a whole FLAC file -> (float32 [frames, ch], AudioInfo)."""
    dec = FlacDecoder(src)
    chunks = []
    while True:
        blk = dec.read_float(65536)
        if blk.shape[0] == 0:
            break
        chunks.append(blk)
    dec.close()
    if chunks:
        data = np.concatenate(chunks, axis=0)
    else:
        data = np.zeros((0, dec.info.channels), dtype=np.float32)
    info = dec.info
    info.frames = data.shape[0]
    return data, info


def read_flac_metadata(src) -> dict:
    """VORBIS_COMMENT fields of a FLAC stream (host-side block parse)."""
    if isinstance(src, str):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = bytes(src)
    out = {}
    if data[:4] != b"fLaC":
        return out
    pos = 4
    while pos + 4 <= len(data):
        hdr = data[pos : pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        blen = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4 : pos + 4 + blen]
        if btype == 4 and len(body) >= 8:  # VORBIS_COMMENT
            p = 0
            vlen = int.from_bytes(body[p : p + 4], "little")
            p += 4 + vlen
            count = int.from_bytes(body[p : p + 4], "little")
            p += 4
            for _ in range(count):
                if p + 4 > len(body):
                    break
                ln = int.from_bytes(body[p : p + 4], "little")
                p += 4
                item = body[p : p + ln].decode("utf-8", errors="replace")
                p += ln
                if "=" in item:
                    k, v = item.split("=", 1)
                    out[k.upper()] = v
        pos += 4 + blen
        if last:
            break
    return out


def read_flac_info(src) -> AudioInfo:
    dec = FlacDecoder(src)
    info = dec.info
    dec.close()
    return info


def write_flac(
    dst: Union[str, "os.PathLike"],
    data: np.ndarray,
    rate: int,
    bits: int = 16,
    blocksize: int = 4096,
    metadata: Optional[dict] = None,
) -> None:
    """Encode float32 [frames, channels] to a FLAC file (offline path)."""
    if data.ndim == 1:
        data = data[:, None]
    enc = FlacEncoder(rate, data.shape[1], bits, blocksize, total_frames_hint=data.shape[0])
    body = enc.header(metadata)
    parts = [body]
    step = 1 << 16
    for start in range(0, data.shape[0], step):
        parts.append(enc.write_float(data[start : start + step]))
    parts.append(enc.finish())
    blob = bytearray(b"".join(parts))
    # Patch final STREAMINFO (frame sizes, total samples, MD5).
    si = enc.streaminfo(with_md5=True)
    blob[FlacEncoder.STREAMINFO_FILE_OFFSET : FlacEncoder.STREAMINFO_FILE_OFFSET + len(si)] = si
    enc.close()
    if hasattr(dst, "write"):
        dst.write(bytes(blob))
    else:
        with open(dst, "wb") as f:
            f.write(bytes(blob))
