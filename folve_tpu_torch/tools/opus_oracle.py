"""Opus fixture encoder for benchmarks and tests.

Like tools/mp3_oracle.py (LAME) this drives a third-party encoder from
the image — the libopus bundled with pygame — purely to MAKE Ogg Opus
fixtures; decode always goes through the from-scratch decoder
(native/opus_api.cc + celt_codec.cc + silk_codec.cc).  The Ogg mux is
our own (RFC 3533 pages, RFC 7845 OpusHead/OpusTags).
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import sysconfig

import numpy as np

RATE = 48000

_APP_AUDIO = 2049
_CTL_FORCE_MODE = 11002
_MODE_SILK, _MODE_CELT = 1000, 1002
_CTL_BITRATE, _CTL_VBR, _CTL_COMPLEXITY = 4002, 4006, 4010
_CTL_LOOKAHEAD = 4027


def _libopus():
    libs = glob.glob(os.path.join(
        sysconfig.get_paths()["platlib"], "pygame.libs", "libopus*.so*"))
    libs = [p for p in libs if "opusfile" not in p]
    if not libs:
        return None
    lib = ctypes.CDLL(libs[0])
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encode_float.restype = ctypes.c_int
    return lib


def opus_available() -> bool:
    return _libopus() is not None


# Ogg CRC: 32-bit, polynomial 0x04c11db7, no reflection, zero init/xor.
_CRC_TABLE = None


def _ogg_crc(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = []
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) if r & 0x80000000 else (r << 1)
            tab.append(r & 0xFFFFFFFF)
        _CRC_TABLE = tab
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) ^ b) & 0xFF]
    return crc


def _page(serial, seq, granule, packets, bos=False, eos=False):
    segs = bytearray()
    body = bytearray()
    for pkt in packets:
        n = len(pkt)
        while n >= 255:
            segs.append(255)
            n -= 255
        segs.append(n)
        body += pkt
    flags = (0x02 if bos else 0) | (0x04 if eos else 0)
    hdr = (b"OggS" + bytes([0, flags]) + struct.pack("<q", granule) +
           struct.pack("<I", serial) + struct.pack("<I", seq) +
           b"\x00\x00\x00\x00" + bytes([len(segs)]) + bytes(segs))
    crc = _ogg_crc(hdr + bytes(body))
    hdr = hdr[:22] + struct.pack("<I", crc) + hdr[26:]
    return hdr + bytes(body)


def mux_ogg_opus(pkts, ch, pre_skip, nsamples, gain_q8=0) -> bytes:
    head = (b"OpusHead" + bytes([1, ch]) + struct.pack("<H", pre_skip) +
            struct.pack("<I", RATE) + struct.pack("<h", gain_q8) + b"\x00")
    tags = (b"OpusTags" + struct.pack("<I", 5) + b"folve" +
            struct.pack("<I", 0))
    out = _page(0x4653, 0, 0, [head], bos=True)
    out += _page(0x4653, 1, 0, [tags])
    from folve_tpu_torch.audio.opus import _lib

    nat = _lib()
    gran = 0
    for i, pkt in enumerate(pkts):
        gran += nat.folve_opus_probe(pkt, len(pkt))
        last = i == len(pkts) - 1
        if last:
            gran = nsamples + pre_skip
        out += _page(0x4653, 2 + i, gran, [pkt], eos=last)
    return out


def opus_encode_ogg(x: np.ndarray, mode: str = "celt",
                    bitrate: int = 96000, frame: int = 960) -> bytes:
    """Encode float PCM [n, ch] at 48 kHz into an Ogg Opus blob using
    the libopus oracle, forced to CELT (music) or SILK (speech) mode."""
    lib = _libopus()
    if lib is None:
        raise RuntimeError("libopus fixture encoder unavailable")
    x = np.ascontiguousarray(x, np.float32)
    n, ch = x.shape
    n = (n // frame) * frame
    x = x[:n]
    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(RATE, ch, _APP_AUDIO, ctypes.byref(err))
    if not enc or err.value:
        raise RuntimeError(f"opus_encoder_create: {err.value}")
    try:
        lib.opus_encoder_ctl(
            ctypes.c_void_p(enc), _CTL_FORCE_MODE,
            _MODE_CELT if mode == "celt" else _MODE_SILK)
        lib.opus_encoder_ctl(ctypes.c_void_p(enc), _CTL_BITRATE, bitrate)
        lib.opus_encoder_ctl(ctypes.c_void_p(enc), _CTL_VBR, 1)
        lib.opus_encoder_ctl(ctypes.c_void_p(enc), _CTL_COMPLEXITY, 10)
        look = ctypes.c_int(0)
        lib.opus_encoder_ctl(ctypes.c_void_p(enc), _CTL_LOOKAHEAD,
                             ctypes.byref(look))
        buf = (ctypes.c_ubyte * 4000)()
        pkts = []
        for off in range(0, n, frame):
            chunk = np.ascontiguousarray(x[off:off + frame])
            ln = lib.opus_encode_float(
                ctypes.c_void_p(enc),
                chunk.ctypes.data_as(ctypes.c_void_p), frame, buf, 4000)
            if ln <= 0:
                raise RuntimeError(f"opus_encode_float: {ln}")
            pkts.append(bytes(buf[:ln]))
        return mux_ogg_opus(pkts, ch, look.value, n)
    finally:
        lib.opus_encoder_destroy(ctypes.c_void_p(enc))
