"""Shared core of the raw-PCM streaming encoders (AIFF/AU/W64/CAF).

Each container provides its own ``header()``; everything else —
the FlacEncoder-shaped interface (write_float / write_int / finish /
streaminfo / close, ``blocksize = 0`` meaning "no framing") and the ONE
canonical float->PCM quantization — lives here.  These containers are
uncompressed and the convolved output has exactly the input's frame
count, so the header carries final sizes up front and nothing needs
patching afterwards.

The quantization convention (scale by 2^(bits-1), round, clip to
[-2^(bits-1), 2^(bits-1)-1]) is bit-compatible with the FLAC encoder's
float path and libsndfile's — a load-bearing invariant: a sample must
quantize identically no matter which output container the stream picked
(validated by the player-interop suite).
"""

from __future__ import annotations

from typing import Optional, Tuple, Type

import numpy as np


class PcmStreamEncoderBase:
    """Subclass contract: set ``_allowed_bits``, ``_little_endian`` and
    ``_error``; implement ``header(metadata)``."""

    _allowed_bits: Tuple[int, ...] = (16, 24)
    _little_endian = False
    _error: Type[Exception] = ValueError

    def __init__(self, rate: int, channels: int, bits: int, total_frames: int):
        if bits not in self._allowed_bits:
            raise self._error(
                f"unsupported {type(self).__name__} depth {bits}"
            )
        self.rate = rate
        self.channels = channels
        self.bits = bits
        self.total_frames = total_frames
        self.blocksize = 0  # no framing
        self._scale = float(1 << (bits - 1))
        self._limit = (1 << (bits - 1)) - 1

    def header(self, metadata: Optional[dict] = None) -> bytes:
        raise NotImplementedError

    def write_float(self, samples: np.ndarray) -> bytes:
        v = np.clip(
            np.round(np.asarray(samples, dtype=np.float64) * self._scale),
            -self._scale,
            self._limit,
        ).astype(np.int64)
        if self.bits == 16:
            return v.astype("<i2" if self._little_endian else ">i2").tobytes()
        if self.bits == 32:
            return v.astype("<i4" if self._little_endian else ">i4").tobytes()
        flat = v.reshape(-1)
        out = np.empty((flat.size, 3), dtype=np.uint8)
        if self._little_endian:
            out[:, 0] = flat & 0xFF
            out[:, 1] = (flat >> 8) & 0xFF
            out[:, 2] = (flat >> 16) & 0xFF
        else:
            out[:, 0] = (flat >> 16) & 0xFF
            out[:, 1] = (flat >> 8) & 0xFF
            out[:, 2] = flat & 0xFF
        return out.tobytes()

    def write_int(self, samples: np.ndarray) -> bytes:
        return self.write_float(np.asarray(samples, np.float64) / self._scale)

    def finish(self) -> bytes:
        return b""

    def streaminfo(self, with_md5: bool = True) -> bytes:
        return b""

    def close(self) -> None:
        pass
