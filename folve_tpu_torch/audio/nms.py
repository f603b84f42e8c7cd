"""NMS (Natural MicroSystems) VBX ADPCM sample-codec support.

The reference convolves anything libsndfile decodes
(convolve-file-handler.cc:62-76); libsndfile 1.1 ships the NMS VBX
ADPCM codec for WAV format tag 0x0038 at 16/24/32 kbps (fmt bit widths
2/3/4, block aligns 42/62/82).  The codec is the from-scratch
``native/nms_codec.cc`` — semantics recovered from the oracle binary
after black-box probing stalled on the predictor (DEVNOTES "Round 4c")
and validated sample-exact (decode) and bit-exact (encode) against the
oracle in tests/test_nms.py; this module is the ctypes binding and the
streaming source.

Blocks are 160 samples; the decoder's predictor state is continuous
across blocks (only the final packed word — an energy tag — is
per-block), so like G.72x a backward seek resets and re-decodes from
the start (streams are 2-4 kB/s).  Mono only, as in libsndfile.
"""

from __future__ import annotations

import ctypes

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo

SAMPLES_PER_BLOCK = 160
# rate type (0=16 kbps, 1=24 kbps, 2=32 kbps) -> block bytes
BLOCK_BYTES = {0: 42, 1: 62, 2: 82}
TYPE_FOR_BITS = {2: 0, 3: 1, 4: 2}


def type_for_codec(codec) -> int:
    from folve_tpu_torch.audio.types import SampleCodec

    return {SampleCodec.NMS_16: 0, SampleCodec.NMS_24: 1,
            SampleCodec.NMS_32: 2}[codec]


def _lib():
    from folve_tpu_torch.utils.native_build import load_native

    lib = load_native()
    if not hasattr(lib.folve_nms_create, "_nms_ready"):
        lib.folve_nms_create.restype = ctypes.c_void_p
        lib.folve_nms_create.argtypes = [ctypes.c_int]
        lib.folve_nms_reset.argtypes = [ctypes.c_void_p]
        lib.folve_nms_close.argtypes = [ctypes.c_void_p]
        lib.folve_nms_decode.restype = ctypes.c_int64
        lib.folve_nms_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p,
        ]
        lib.folve_nms_encode.restype = ctypes.c_int64
        lib.folve_nms_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        lib.folve_nms_create._nms_ready = True
    return lib


def nms_frames_in(nbytes: int, rate_type: int) -> int:
    """Frame count like the oracle: ceil(bytes / block) * 160."""
    bb = BLOCK_BYTES[rate_type]
    return -(-nbytes // bb) * SAMPLES_PER_BLOCK


def decode_nms(raw: bytes, rate_type: int) -> np.ndarray:
    """Whole coded payload -> float32 [n, 1] (fresh decoder state)."""
    lib = _lib()
    h = lib.folve_nms_create(rate_type)
    if not h:
        raise MemoryError("nms state")
    try:
        out = np.zeros(nms_frames_in(len(raw), rate_type), np.int16)
        n = lib.folve_nms_decode(h, raw, len(raw),
                                 out.ctypes.data_as(ctypes.c_void_p))
        return (out[:n].astype(np.float32) / 32768.0).reshape(-1, 1)
    finally:
        lib.folve_nms_close(h)


def encode_nms(pcm: np.ndarray, rate_type: int) -> bytes:
    """int16 mono PCM -> packed NMS blocks (final block zero-padded).

    Bit-exact with the oracle encoder; used by fixtures and round-trip
    tests so NMS coverage does not depend on the oracle being present.
    """
    lib = _lib()
    h = lib.folve_nms_create(rate_type)
    if not h:
        raise MemoryError("nms state")
    try:
        x = np.ascontiguousarray(pcm, np.int16).reshape(-1)
        nblocks = max(1, -(-x.shape[0] // SAMPLES_PER_BLOCK))
        out = ctypes.create_string_buffer(nblocks * BLOCK_BYTES[rate_type])
        n = lib.folve_nms_encode(h, x.ctypes.data_as(ctypes.c_void_p),
                                 x.shape[0], out)
        return out.raw[:n]
    finally:
        lib.folve_nms_close(h)


class NmsSource:
    """Forward-streaming decode source (AudioSource protocol) over a
    coded NMS region of an open file."""

    def __init__(self, f, info: AudioInfo, data_offset: int,
                 data_size: int, rate_type: int):
        self._f = f
        self.info = info
        self._off = data_offset
        self._size = data_size
        self._type = rate_type
        self._block = BLOCK_BYTES[rate_type]
        self._lib = _lib()
        self._h = self._lib.folve_nms_create(rate_type)
        if not self._h:
            raise MemoryError("nms state")
        self._cpos = 0  # coded bytes consumed
        self._dpos = 0  # decoded frames handed out
        self._pending = np.zeros((0, 1), np.float32)

    def _decode_more(self) -> bool:
        if self._cpos >= self._size:
            return False
        # whole blocks, except the (possibly partial) final one
        chunk = min(self._size - self._cpos, self._block * 256)
        if self._cpos + chunk < self._size:
            chunk -= chunk % self._block
        self._f.seek(self._off + self._cpos)
        raw = self._f.read(chunk)
        self._cpos += chunk
        if len(raw) < chunk:  # file shrank underneath us
            self._cpos = self._size
        if not raw:
            return False
        out = np.zeros(nms_frames_in(len(raw), self._type), np.int16)
        n = self._lib.folve_nms_decode(
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
            self._lib.folve_nms_reset(self._h)
            self._cpos = self._dpos = 0
            self._pending = np.zeros((0, 1), np.float32)
        while self._dpos < frame:
            skip = self.read_float(min(frame - self._dpos, 1 << 14))
            if skip.shape[0] == 0:
                break

    def close(self) -> None:
        if self._h:
            self._lib.folve_nms_close(self._h)
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
