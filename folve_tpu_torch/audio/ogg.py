"""Ogg Vorbis decoding via the in-repo native decoder.

The reference consumes Vorbis through libsndfile's libvorbis backend
(README.md's ogg support; output re-encoded as FLAC because ogg can't
be streamed out, convolve-file-handler.cc:237-243).  Here the decoder
is from scratch — ``native/vorbis_codec.cc`` implements Ogg framing,
codebooks, floors 0/1, residues 0/1/2, coupling and the IMDCT per the
public Vorbis I specification; no third-party codec library is
involved (same bar as the FLAC codec, native/flac_codec.cc:1-6).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec
from folve_tpu_torch.utils.native_build import load_native


class OggError(ValueError):
    pass


class _FolveVorbisInfo(ctypes.Structure):
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
        lib.folve_vorbis_open.restype = ctypes.c_void_p
        lib.folve_vorbis_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.folve_vorbis_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(_FolveVorbisInfo),
        ]
        lib.folve_vorbis_read.restype = ctypes.c_int64
        lib.folve_vorbis_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.folve_vorbis_rewind.restype = ctypes.c_int
        lib.folve_vorbis_rewind.argtypes = [ctypes.c_void_p]
        lib.folve_vorbis_close.argtypes = [ctypes.c_void_p]
        lib.folve_vorbis_comments.restype = ctypes.c_uint32
        lib.folve_vorbis_comments.argtypes = [ctypes.c_void_p]
        lib.folve_vorbis_comment_len.restype = ctypes.c_uint64
        lib.folve_vorbis_comment_len.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.folve_vorbis_comment_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint32,
            ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def vorbis_available() -> bool:
    """Always true — the decoder ships with the native library."""
    try:
        return _get_lib() is not None
    except Exception:
        return False


class OggSource:
    """Streaming Vorbis decode source (AudioSource protocol)."""

    def __init__(self, path: str):
        lib = _get_lib()
        self._lib = lib
        with open(path, "rb") as f:
            data = f.read()
        # folve_vorbis_open copies the bytes; do not retain them here
        # (a second copy per open stream adds up on large files).
        self._h = lib.folve_vorbis_open(data, len(data))
        if not self._h:
            raise OggError("cannot open ogg stream")
        info = _FolveVorbisInfo()
        lib.folve_vorbis_info(self._h, ctypes.byref(info))
        if info.channels == 0 or info.rate == 0:
            lib.folve_vorbis_close(self._h)
            self._h = None
            raise OggError("no vorbis info")
        self.info = AudioInfo(
            rate=int(info.rate),
            channels=int(info.channels),
            frames=max(0, int(info.frames)),
            container=Container.OGG,
            codec=SampleCodec.VORBIS,
            bits_per_sample=16,  # nominal; vorbis is float internally
        )

    def read_float(self, nframes: int) -> np.ndarray:
        ch = self.info.channels
        out = np.empty((nframes, ch), dtype=np.float32)
        n = self._lib.folve_vorbis_read(self._h, out.ctypes.data, nframes)
        if n < 0:
            raise OggError("vorbis decode error")
        return out[:n]

    def comments(self) -> dict:
        lib = self._lib
        out = {}
        for i in range(lib.folve_vorbis_comments(self._h)):
            ln = lib.folve_vorbis_comment_len(self._h, i)
            buf = ctypes.create_string_buffer(int(ln))
            lib.folve_vorbis_comment_copy(self._h, i, buf)
            item = buf.raw.decode("utf-8", errors="replace")
            if "=" in item:
                k, v = item.split("=", 1)
                out[k.upper()] = v
        return out

    def rewind(self) -> None:
        if self._lib.folve_vorbis_rewind(self._h) != 0:
            raise OggError("rewind failed")

    def close(self) -> None:
        if self._h:
            self._lib.folve_vorbis_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_ogg(path: str) -> tuple[np.ndarray, AudioInfo]:
    from folve_tpu_torch.audio.source import drain_source

    return drain_source(OggSource(path))


def read_ogg_info(path: str) -> AudioInfo:
    src = OggSource(path)
    info = src.info
    src.close()
    return info


def read_ogg_comments(path: str) -> dict:
    """Vorbis comments as a vorbis-style tag dict (the reference carries
    these into the FLAC output via sf_get_string/sf_set_string,
    convolve-file-handler.cc:484-495).  {} for unreadable input."""
    if not os.path.exists(path):
        return {}
    try:
        src = OggSource(path)
    except Exception:
        return {}
    try:
        return src.comments()
    finally:
        src.close()
