"""CCITT G.721/G.723 ADPCM (G.726 family) sample-codec support.

The reference convolves anything libsndfile decodes
(convolve-file-handler.cc:62-76); libsndfile ships Sun's public G.72x
ADPCM for AU encodings 23 (G.721, 32 kbps), 25 (G.723, 24 kbps) and
26 (G.723, 40 kbps), and WAV format tag 0x0040 (G.721).  The decoder
is the from-scratch ``native/g72x_codec.cc`` (semantics recovered
behaviorally and validated sample-exact against oracle-decoded probes —
see tools/g72x_probe.py); this module is the ctypes binding and the
streaming source.

The codes form one continuous little-endian bitstream (no framing) and
the predictor state is continuous across the whole stream, so like GSM
a backward seek resets and re-decodes from the start (the streams are
3-5 kB/s — microseconds of work).  Mono only, as in libsndfile.
"""

from __future__ import annotations

import ctypes

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo

# bits per code for each rate
G721_32_BITS = 4
G723_24_BITS = 3
G723_40_BITS = 5


def _lib():
    from folve_tpu_torch.utils.native_build import load_native

    lib = load_native()
    if not hasattr(lib.folve_g72x_create, "_g72x_ready"):
        lib.folve_g72x_create.restype = ctypes.c_void_p
        lib.folve_g72x_create.argtypes = [ctypes.c_int]
        lib.folve_g72x_reset.argtypes = [ctypes.c_void_p]
        lib.folve_g72x_close.argtypes = [ctypes.c_void_p]
        lib.folve_g72x_decode.restype = ctypes.c_int64
        lib.folve_g72x_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p,
        ]
        lib.folve_g72x_create._g72x_ready = True
    return lib


def g72x_frames_in(nbytes: int, bits: int) -> int:
    return nbytes * 8 // bits


def decode_g72x(raw: bytes, bits: int) -> np.ndarray:
    """Whole coded payload -> float32 [n, 1] (fresh decoder state)."""
    lib = _lib()
    h = lib.folve_g72x_create(bits)
    if not h:
        raise MemoryError("g72x state")
    try:
        out = np.zeros(len(raw) * 8 // bits + 8, np.int16)
        n = lib.folve_g72x_decode(h, raw, len(raw),
                                  out.ctypes.data_as(ctypes.c_void_p))
        return (out[:n].astype(np.float32) / 32768.0).reshape(-1, 1)
    finally:
        lib.folve_g72x_close(h)


class G72xSource:
    """Forward-streaming decode source (AudioSource protocol) over a
    coded G.72x region of an open file."""

    def __init__(self, f, info: AudioInfo, data_offset: int,
                 data_size: int, bits: int):
        self._f = f
        self.info = info
        self._off = data_offset
        self._size = data_size
        self._bits = bits
        self._lib = _lib()
        self._h = self._lib.folve_g72x_create(bits)
        if not self._h:
            raise MemoryError("g72x state")
        self._cpos = 0  # coded bytes consumed
        self._dpos = 0  # decoded frames handed out
        self._pending = np.zeros((0, 1), np.float32)

    def _decode_more(self) -> bool:
        if self._cpos >= self._size:
            return False
        chunk = min(self._size - self._cpos, 1 << 14)
        self._f.seek(self._off + self._cpos)
        raw = self._f.read(chunk)
        self._cpos += chunk
        if len(raw) < chunk:  # file shrank underneath us
            self._cpos = self._size
        if not raw:
            return False
        out = np.zeros(len(raw) * 8 // self._bits + 8, np.int16)
        n = self._lib.folve_g72x_decode(
            self._h, bytes(raw), len(raw),
            out.ctypes.data_as(ctypes.c_void_p))
        if n <= 0:
            return False
        self._pending = np.concatenate(
            [self._pending,
             (out[:n].astype(np.float32) / 32768.0).reshape(-1, 1)])
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
            self._lib.folve_g72x_reset(self._h)
            self._cpos = self._dpos = 0
            self._pending = np.zeros((0, 1), np.float32)
        while self._dpos < frame:
            skip = self.read_float(min(frame - self._dpos, 1 << 14))
            if skip.shape[0] == 0:
                break

    def close(self) -> None:
        if self._h:
            self._lib.folve_g72x_close(self._h)
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
