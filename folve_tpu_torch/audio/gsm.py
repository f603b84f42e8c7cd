"""GSM 6.10 sample-codec support (decode only).

The reference convolves anything libsndfile decodes
(convolve-file-handler.cc:62-76); libsndfile links libgsm for the
GSM610 subtype in WAV/W64 (Microsoft "WAV49" 65-byte two-frame blocks)
and AIFC ("GSM " compression, plain 33-byte frames).  The decoder
itself is a from-scratch ETSI 06.10 implementation in
``native/gsm_codec.cc``; this module is the ctypes binding plus the
streaming source.

GSM is stateful ACROSS frames (residual history, synthesis lattice,
de-emphasis memory), so unlike the ADPCM block codecs it cannot decode
from an arbitrary block boundary: the source streams forward and a
backward seek resets the decoder and re-decodes from the start (files
are 1625 bytes/s — a full re-decode is microseconds).
"""

from __future__ import annotations

import ctypes

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo

_FRAME = {True: (65, 320), False: (33, 160)}  # wav49 -> (bytes, samples)


def _lib():
    from folve_tpu_torch.utils.native_build import load_native

    lib = load_native()
    if not hasattr(lib.folve_gsm_create, "_gsm_ready"):
        lib.folve_gsm_create.restype = ctypes.c_void_p
        lib.folve_gsm_create.argtypes = [ctypes.c_int]
        lib.folve_gsm_reset.argtypes = [ctypes.c_void_p]
        lib.folve_gsm_close.argtypes = [ctypes.c_void_p]
        lib.folve_gsm_decode.restype = ctypes.c_int64
        lib.folve_gsm_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p,
        ]
        lib.folve_gsm_create._gsm_ready = True
    return lib


def gsm_frames_in(nbytes: int, wav49: bool) -> int:
    """Decoded sample count for a coded payload.  WAV49 counts a
    partial tail block as a full (zero-padded) one — ceil, matching
    libsndfile's blockwise reader; native 33-byte framing floors."""
    ba, spb = _FRAME[wav49]
    if wav49:
        return -(-nbytes // ba) * spb
    return (nbytes // ba) * spb


def decode_gsm(raw: bytes, wav49: bool) -> np.ndarray:
    """Whole coded payload -> float32 [n, 1] (fresh decoder state)."""
    lib = _lib()
    ba, spb = _FRAME[wav49]
    if wav49 and len(raw) % ba:
        raw = raw + b"\0" * (ba - len(raw) % ba)  # zero-pad tail block
    h = lib.folve_gsm_create(1 if wav49 else 0)
    if not h:
        raise MemoryError("gsm state")
    try:
        out = np.zeros((len(raw) // ba) * spb, np.int16)
        n = lib.folve_gsm_decode(h, raw, len(raw),
                                 out.ctypes.data_as(ctypes.c_void_p))
        # n < full on a bad native-frame signature: short decode.
        return (out[:n].astype(np.float32) / 32768.0).reshape(-1, 1)
    finally:
        lib.folve_gsm_close(h)


class GsmSource:
    """Forward-streaming decode source (AudioSource protocol) over a
    coded GSM region of an open file."""

    def __init__(self, f, info: AudioInfo, data_offset: int,
                 data_size: int, wav49: bool):
        self._f = f
        self.info = info
        self._off = data_offset
        self._size = data_size
        self._wav49 = wav49
        self._ba, self._spb = _FRAME[wav49]
        self._lib = _lib()
        self._h = self._lib.folve_gsm_create(1 if wav49 else 0)
        if not self._h:
            raise MemoryError("gsm state")
        self._cpos = 0  # coded bytes consumed
        self._dpos = 0  # decoded frames handed out
        self._pending = np.zeros((0, 1), np.float32)

    def _decode_more(self) -> bool:
        """Decode the next bounded run of coded units into _pending."""
        if self._cpos >= self._size:
            return False
        chunk = min(self._size - self._cpos, 512 * self._ba)
        self._f.seek(self._off + self._cpos)
        raw = self._f.read(chunk)
        self._cpos += chunk
        if len(raw) < chunk:  # file shrank underneath us
            self._cpos = self._size
        if self._wav49 and len(raw) % self._ba and \
                self._cpos >= self._size:
            raw = raw + b"\0" * (self._ba - len(raw) % self._ba)
        nblocks = len(raw) // self._ba
        if nblocks == 0:
            return False
        out = np.zeros(nblocks * self._spb, np.int16)
        n = self._lib.folve_gsm_decode(
            self._h, bytes(raw[: nblocks * self._ba]),
            nblocks * self._ba, out.ctypes.data_as(ctypes.c_void_p))
        if n < nblocks * self._spb:
            # Bad native-frame signature mid-chunk: keep what decoded,
            # then stop for good (short-decode).
            self._cpos = self._size
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
            self._lib.folve_gsm_reset(self._h)
            self._cpos = self._dpos = 0
            self._pending = np.zeros((0, 1), np.float32)
        while self._dpos < frame:
            skip = self.read_float(min(frame - self._dpos, 1 << 14))
            if skip.shape[0] == 0:
                break

    def close(self) -> None:
        if self._h:
            self._lib.folve_gsm_close(self._h)
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
