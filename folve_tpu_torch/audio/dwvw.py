"""DWVW (Delta Word Variable Width) sample-codec support.

The reference convolves anything libsndfile decodes
(convolve-file-handler.cc:62-76); libsndfile carries the TX16W/Typhoon
DWVW compression for AIFC at 12/16/24-bit depths.  The decoder is the
from-scratch ``native/dwvw_codec.cc`` (bitstream recovered behaviorally
against the oracle with crafted bit vectors; oracle-exact on encoded
streams — tests/test_dwvw.py).  This module is the ctypes binding, the
streaming source, and a test/CLI encoder.

The codes form one continuous MSB-first bitstream with no framing, and
the width/previous-sample state is continuous across the whole stream,
so like GSM a backward seek resets and re-decodes from the start.
Mono only, as in libsndfile.

Note: the reference's own libsndfile build cannot actually read 12-bit
DWVW (its reader returns zero frames — probed in tests/test_dwvw.py);
we decode all three depths.
"""

from __future__ import annotations

import ctypes

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo


def _lib():
    from folve_tpu_torch.utils.native_build import load_native

    lib = load_native()
    if not hasattr(lib.folve_dwvw_create, "_dwvw_ready"):
        lib.folve_dwvw_create.restype = ctypes.c_void_p
        lib.folve_dwvw_create.argtypes = [ctypes.c_int]
        lib.folve_dwvw_reset.argtypes = [ctypes.c_void_p]
        lib.folve_dwvw_close.argtypes = [ctypes.c_void_p]
        lib.folve_dwvw_decode.restype = ctypes.c_int64
        lib.folve_dwvw_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.folve_dwvw_enc_create.restype = ctypes.c_void_p
        lib.folve_dwvw_enc_create.argtypes = [ctypes.c_int]
        lib.folve_dwvw_enc_close.argtypes = [ctypes.c_void_p]
        lib.folve_dwvw_encode.restype = ctypes.c_int64
        lib.folve_dwvw_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.folve_dwvw_create._dwvw_ready = True
    return lib


def decode_dwvw(raw: bytes, bits: int, max_frames: int | None = None
                ) -> np.ndarray:
    """Whole coded payload -> float32 [n, 1] (fresh decoder state).
    Truncated payloads short-decode (a trailing partial code is
    dropped, like the other coded formats)."""
    lib = _lib()
    h = lib.folve_dwvw_create(bits)
    if not h:
        raise ValueError(f"unsupported DWVW depth {bits}")
    try:
        # The stream can't code more samples than it has bits.
        cap = len(raw) * 8
        if max_frames is not None:
            cap = min(cap, max_frames)
        out = np.empty(max(1, cap), np.int32)
        n = lib.folve_dwvw_decode(
            h, raw, len(raw), out.ctypes.data_as(ctypes.c_void_p), cap)
    finally:
        lib.folve_dwvw_close(h)
    return (out[:max(0, n)].astype(np.float32)
            / np.float32(1 << (bits - 1))).reshape(-1, 1)


def encode_dwvw(samples: np.ndarray, bits: int) -> bytes:
    """Integer samples (at `bits` depth) -> coded payload.  Used by the
    offline CLI fixtures and tests (the FUSE output path re-encodes
    DWVW inputs as plain-PCM AIFF — see runtime/handler.py's policy
    note)."""
    lib = _lib()
    e = lib.folve_dwvw_enc_create(bits)
    if not e:
        raise ValueError(f"unsupported DWVW depth {bits}")
    try:
        vals = np.ascontiguousarray(samples, np.int32).reshape(-1)
        cap = vals.size * (bits + 10) // 8 + 16
        out = np.empty(cap, np.uint8)
        n = lib.folve_dwvw_encode(
            e, vals.ctypes.data_as(ctypes.c_void_p), vals.size, 1,
            out.ctypes.data_as(ctypes.c_void_p), cap)
    finally:
        lib.folve_dwvw_enc_close(e)
    return out[:n].tobytes()


class DwvwSource:
    """Forward-streaming decode source (AudioSource protocol) over the
    coded SSND region of an open file."""

    _CHUNK = 1 << 16  # coded bytes per refill

    def __init__(self, f, info: AudioInfo, data_offset: int, data_size: int):
        self._f = f
        self.info = info
        self._off = data_offset
        self._size = data_size
        self._lib = _lib()
        self._h = self._lib.folve_dwvw_create(info.bits_per_sample)
        if not self._h:
            raise MemoryError("dwvw state")
        self._cpos = 0  # coded bytes consumed
        self._dpos = 0  # decoded frames handed out
        self._pending = np.zeros((0, 1), np.float32)
        self._scale = np.float32(1.0 / (1 << (info.bits_per_sample - 1)))

    def _decode_more(self) -> bool:
        if self._cpos >= self._size:
            return False
        chunk = min(self._size - self._cpos, self._CHUNK)
        self._f.seek(self._off + self._cpos)
        raw = self._f.read(chunk)
        self._cpos += chunk
        if len(raw) < chunk:  # file shrank underneath us
            self._cpos = self._size
        if not raw:
            return False
        # +64: the reservoir may carry a finished-but-unread code tail
        # from the previous call; every sample costs >= 1 bit, so this
        # bounds the output of (carry + raw) exactly.
        cap = len(raw) * 8 + 64
        out = np.empty(cap, np.int32)
        n = self._lib.folve_dwvw_decode(
            self._h, raw, len(raw),
            out.ctypes.data_as(ctypes.c_void_p), cap)
        if n <= 0:
            # Partial code carried in the reservoir; more bytes needed.
            return self._cpos < self._size
        self._pending = np.concatenate(
            [self._pending,
             (out[:n].astype(np.float32) * self._scale).reshape(-1, 1)])
        return True

    def read_float(self, nframes: int) -> np.ndarray:
        take = max(0, min(nframes, self.info.frames - self._dpos))
        if take == 0:
            return np.zeros((0, 1), np.float32)
        while self._pending.shape[0] < take:
            if not self._decode_more():
                break
        out = self._pending[:take]
        self._pending = self._pending[out.shape[0]:]
        self._dpos += out.shape[0]
        if out.shape[0] == 0:
            self._dpos = self.info.frames  # never wedge the pump loop
        return out

    def seek(self, frame: int) -> None:
        frame = max(0, min(frame, self.info.frames))
        if frame < self._dpos:  # backward: reset and re-decode
            self._lib.folve_dwvw_reset(self._h)
            self._cpos = self._dpos = 0
            self._pending = np.zeros((0, 1), np.float32)
        while self._dpos < frame:
            skip = self.read_float(min(frame - self._dpos, 1 << 14))
            if skip.shape[0] == 0:
                break

    def close(self) -> None:
        if self._h:
            self._lib.folve_dwvw_close(self._h)
            self._h = None
        try:
            self._f.close()
        except Exception:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
