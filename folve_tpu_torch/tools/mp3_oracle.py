"""Dev/test-only oracles for the MP3 codec work.

Binds the system libmpg123 (reference DECODER) and libmp3lame
(fixture ENCODER) via ctypes.  These are used ONLY by tests and by
tools/gen_mp3_tables.py (the black-box recovery of the ISO 11172-3
Huffman code tables); the product decoder (native/mp3_codec.cc) has no
dependency on either.
"""

from __future__ import annotations

import ctypes
import glob
import os
import sysconfig
from typing import Optional

import numpy as np

_MPG123_PATHS = [
    "/usr/lib/x86_64-linux-gnu/libmpg123.so.0",
    "libmpg123.so.0",
]
_LAME_PATHS = [
    "/usr/lib/x86_64-linux-gnu/libmp3lame.so.0",
    "libmp3lame.so.0",
]

MPG123_ENC_FLOAT_32 = 0x200
MPG123_OK = 0
MPG123_NEW_FORMAT = -11
MPG123_NEED_MORE = -10
MPG123_DONE = -12


def _load(paths):
    for p in paths:
        try:
            return ctypes.CDLL(p)
        except OSError:
            continue
    # pygame bundles libmpg123 too
    for p in glob.glob(os.path.join(
        sysconfig.get_paths()["platlib"], "pygame.libs", "libmpg123*")
    ):
        try:
            return ctypes.CDLL(p)
        except OSError:
            continue
    return None


_mpg = None
_lame = None


def mpg123_available() -> bool:
    return _get_mpg() is not None


def lame_available() -> bool:
    return _get_lame() is not None


def _get_mpg():
    global _mpg
    if _mpg is None:
        lib = _load(_MPG123_PATHS)
        if lib is None:
            return None
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
        ]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int
        ]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _mpg = lib
    return _mpg


def _get_lame():
    global _lame
    if _lame is None:
        lib = _load(_LAME_PATHS)
        if lib is None:
            return None
        lib.lame_init.restype = ctypes.c_void_p
        for name in (
            "lame_set_in_samplerate", "lame_set_num_channels",
            "lame_set_brate", "lame_set_mode", "lame_set_VBR",
            "lame_set_quality", "lame_set_bWriteVbrTag",
        ):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer_ieee_float.restype = ctypes.c_int
        lib.lame_encode_buffer_ieee_float.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int
        ]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _lame = lib
    return _lame


def mpg123_decode(data: bytes, rate: int = 44100, channels: int = 1,
                  max_samples: int = 1 << 22) -> np.ndarray:
    """Decode an MP3 byte stream -> float32 [n, channels] via libmpg123
    (feed API, forced float output at the given rate/channels)."""
    lib = _get_mpg()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError("mpg123_new failed")
    try:
        lib.mpg123_format_none(h)
        for r in (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000):
            lib.mpg123_format(h, r, 3, MPG123_ENC_FLOAT_32)
        if lib.mpg123_open_feed(h) != MPG123_OK:
            raise RuntimeError("open_feed failed")
        lib.mpg123_feed(h, data, len(data))
        out = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        got_channels = channels
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                out.append(bytes(buf.raw[: done.value]))
            if rc == MPG123_NEW_FORMAT:
                r = ctypes.c_long(0)
                ch = ctypes.c_int(0)
                enc = ctypes.c_int(0)
                lib.mpg123_getformat(
                    h, ctypes.byref(r), ctypes.byref(ch), ctypes.byref(enc)
                )
                got_channels = ch.value or channels
                continue
            if rc in (MPG123_NEED_MORE, MPG123_DONE):
                break
            if rc != MPG123_OK:
                break
            if sum(len(o) for o in out) > max_samples * 4:
                break
        blob = b"".join(out)
        x = np.frombuffer(blob, np.float32)
        n = x.size // got_channels
        return x[: n * got_channels].reshape(n, got_channels)
    finally:
        lib.mpg123_delete(h)


def lame_encode(x: np.ndarray, rate: int = 44100, kbps: int = 128,
                mode: Optional[int] = None, vbr: Optional[int] = None,
                quality: int = 2, vbr_tag: bool = False) -> bytes:
    """Encode float32 [n, ch] PCM to an MP3 byte stream via libmp3lame.
    mode: 0=stereo 1=joint 3=mono (default by channels); vbr: 0=CBR
    (default), 4=VBR default."""
    lib = _get_lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    gf = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(gf, rate)
        lib.lame_set_num_channels(gf, ch)
        lib.lame_set_brate(gf, kbps)
        lib.lame_set_quality(gf, quality)
        lib.lame_set_bWriteVbrTag(gf, 1 if vbr_tag else 0)
        if mode is None:
            mode = 3 if ch == 1 else 1
        lib.lame_set_mode(gf, mode)
        if vbr is not None:
            lib.lame_set_VBR(gf, vbr)
        if lib.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")
        left = np.ascontiguousarray(x[:, 0], np.float32)
        right = np.ascontiguousarray(x[:, ch - 1], np.float32)
        out = ctypes.create_string_buffer(int(1.25 * n) + 7200 + (1 << 16))
        nb = lib.lame_encode_buffer_ieee_float(
            gf, left.ctypes.data, right.ctypes.data, n, out, len(out)
        )
        if nb < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({nb})")
        blob = bytes(out.raw[:nb])
        nb = lib.lame_encode_flush(gf, out, len(out))
        if nb > 0:
            blob += bytes(out.raw[:nb])
        return blob
    finally:
        lib.lame_close(gf)


_TWOLAME_PATHS = [
    "/usr/lib/x86_64-linux-gnu/libtwolame.so.0",
    "libtwolame.so.0",
]
_twolame = None


def twolame_available() -> bool:
    return _get_twolame() is not None


def _get_twolame():
    global _twolame
    if _twolame is None:
        lib = _load(_TWOLAME_PATHS)
        if lib is None:
            return None
        lib.twolame_init.restype = ctypes.c_void_p
        for name in ("twolame_set_in_samplerate", "twolame_set_out_samplerate",
                     "twolame_set_bitrate", "twolame_set_num_channels",
                     "twolame_set_mode"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.twolame_init_params.argtypes = [ctypes.c_void_p]
        lib.twolame_init_params.restype = ctypes.c_int
        lib.twolame_encode_buffer_float32_interleaved.restype = ctypes.c_int
        lib.twolame_encode_buffer_float32_interleaved.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.twolame_encode_flush.restype = ctypes.c_int
        lib.twolame_encode_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int
        ]
        # NOTE: twolame_close takes twolame_options** — passing the
        # handle directly corrupts the heap.
        lib.twolame_close.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        _twolame = lib
    return _twolame


def twolame_encode(x: np.ndarray, rate: int = 44100, kbps: int = 192,
                   mode: Optional[int] = None) -> bytes:
    """Encode float32 [n, ch] PCM to MPEG Layer II via libtwolame
    (test-only fixture encoder)."""
    lib = _get_twolame()
    if lib is None:
        raise RuntimeError("libtwolame not available")
    if x.ndim == 1:
        x = x[:, None]
    g = lib.twolame_init()
    lib.twolame_set_in_samplerate(g, rate)
    lib.twolame_set_out_samplerate(g, rate)
    lib.twolame_set_num_channels(g, x.shape[1])
    lib.twolame_set_bitrate(g, kbps)
    if mode is not None:
        lib.twolame_set_mode(g, mode)
    if lib.twolame_init_params(g) != 0:
        raise RuntimeError("twolame_init_params failed")
    buf = ctypes.create_string_buffer(len(x) * 4 + 65536)
    xx = np.ascontiguousarray(x, np.float32)
    n = lib.twolame_encode_buffer_float32_interleaved(
        g, xx.ctypes.data, len(x), buf, len(buf)
    )
    if n < 0:
        raise RuntimeError(f"twolame encode failed ({n})")
    blob = bytes(buf.raw[:n])
    n = lib.twolame_encode_flush(g, buf, len(buf))
    blob += bytes(buf.raw[:n])
    h = ctypes.c_void_p(g)
    lib.twolame_close(ctypes.byref(h))
    return blob
