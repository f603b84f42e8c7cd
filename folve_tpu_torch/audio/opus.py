"""Ogg Opus (RFC 7845) decode through the from-scratch Opus decoder.

The reference convolves anything libsndfile decodes; libsndfile 1.1
decodes Ogg Opus via libopus when present.  Here the Ogg layer reuses
the in-repo page/packet walker (oggflac.py) and packets decode through
``native/opus_api.cc`` — the packet layer dispatching the from-scratch
CELT (``native/celt_codec.cc``, music modes) and SILK
(``native/silk_codec.cc``, speech modes) decoders, including hybrid
frames and mode-switching streams.  Validated range-state bit-exact
(the standard's own conformance check) and PCM-exact/float-precise
against the libopus test oracle in tests/test_opus.py and
tests/test_silk.py.

Scope: all TOC configs 0..31, channel mapping family 0, mono or
stereo.  Malformed packets raise at open, so the caller's
probe-and-fallback serves the file unfiltered rather than ever serving
a mis-decode.

Opus always decodes at 48 kHz (RFC 7845 section 5.1; libsndfile reports
the same), with OpusHead pre-skip trimmed, the final page's granule
position bounding the length, and the output gain applied.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class OpusError(ValueError):
    pass


def _lib():
    from folve_tpu_torch.utils.native_build import load_native

    lib = load_native()
    if not hasattr(lib.folve_opus_create, "_opus_ready"):
        lib.folve_opus_create.restype = ctypes.c_void_p
        lib.folve_opus_create.argtypes = [ctypes.c_int]
        lib.folve_opus_reset.argtypes = [ctypes.c_void_p]
        lib.folve_opus_close.argtypes = [ctypes.c_void_p]
        lib.folve_opus_probe.restype = ctypes.c_int
        lib.folve_opus_probe.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.folve_opus_decode.restype = ctypes.c_int
        lib.folve_opus_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.folve_opus_final_range.restype = ctypes.c_uint32
        lib.folve_opus_final_range.argtypes = [ctypes.c_void_p]
        lib.folve_opus_decode_batch.restype = ctypes.c_int
        lib.folve_opus_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.folve_opus_create._opus_ready = True
    return lib


def _final_granule(blob: bytes, serial: int) -> int:
    """Greatest granule position of completed packets for the stream."""
    pos, best = 0, 0
    n = len(blob)
    while pos + 27 <= n:
        if blob[pos:pos + 4] != b"OggS":
            pos += 1
            continue
        gran = struct.unpack("<q", blob[pos + 6:pos + 14])[0]
        ser = struct.unpack("<I", blob[pos + 14:pos + 18])[0]
        nseg = blob[pos + 26]
        seg = blob[pos + 27:pos + 27 + nseg]
        if len(seg) < nseg:
            break
        if ser == serial and gran >= 0:
            best = max(best, gran)
        pos += 27 + nseg + sum(seg)
    return best


class _Parsed:
    __slots__ = ("channels", "pre_skip", "gain", "frames", "packets")


def _parse(blob: bytes) -> _Parsed:
    from folve_tpu_torch.audio.oggflac import _iter_packets

    if blob[:4] != b"OggS" or len(blob) < 28:
        raise OpusError("not an Ogg stream")
    serial = struct.unpack("<I", blob[14:18])[0]
    packets = list(_iter_packets(blob, serial))
    if not packets or packets[0][:8] != b"OpusHead":
        raise OpusError("no OpusHead")
    head = packets[0]
    if len(head) < 19:
        raise OpusError("short OpusHead")
    version, channels = head[8], head[9]
    if version >> 4 != 0:
        raise OpusError(f"OpusHead version {version}")
    pre_skip = struct.unpack("<H", head[10:12])[0]
    gain_q8 = struct.unpack("<h", head[16:18])[0]
    family = head[18]
    if family != 0 or channels not in (1, 2):
        raise OpusError("unsupported channel mapping")

    lib = _lib()
    audio = []
    total = 0
    for pkt in packets[1:]:
        if pkt[:8] == b"OpusTags":
            continue
        if not pkt:
            continue
        ns = lib.folve_opus_probe(pkt, len(pkt))
        if ns <= 0:
            raise OpusError("malformed Opus packet")
        audio.append((pkt, ns))
        total += ns

    p = _Parsed()
    p.channels = channels
    p.pre_skip = pre_skip
    p.gain = float(10.0 ** (gain_q8 / (20.0 * 256.0)))
    gran = _final_granule(blob, serial)
    frames = total - pre_skip
    if gran > 0:
        frames = min(frames, gran - pre_skip)
    p.frames = max(0, frames)
    p.packets = audio
    return p


def _info(p: _Parsed) -> AudioInfo:
    return AudioInfo(
        rate=48000, channels=p.channels, frames=p.frames,
        container=Container.OGG, codec=SampleCodec.OPUS,
        bits_per_sample=16,
    )


class OpusSource:
    """Streaming decode source (AudioSource protocol).  Decoder state is
    continuous across packets, so a backward seek resets and re-decodes
    (the decoder runs far above realtime; see tests)."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            blob = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                blob = f.read()
        self._p = _parse(blob)
        self.info = _info(self._p)
        self._lib = _lib()
        self._h = self._lib.folve_opus_create(self._p.channels)
        if not self._h:
            raise MemoryError("opus state")
        self._pkt = 0       # next packet index
        self._dpos = 0      # frames handed out
        self._skip = self._p.pre_skip
        self._pending = np.zeros((0, self._p.channels), np.float32)
        # Flat packet table for the batched native call (one FFI crossing
        # per read instead of per packet; native/opus_api.cc
        # folve_opus_decode_batch).
        pkts = self._p.packets
        self._blob = b"".join(pk for pk, _ in pkts)
        offs, lens, cum = [], [], [0]
        o = 0
        for pk, ns in pkts:
            offs.append(o)
            lens.append(len(pk))
            cum.append(cum[-1] + ns)
            o += len(pk)
        self._offs = np.asarray(offs, np.int32)
        self._lens = np.asarray(lens, np.int32)
        self._cum_ns = np.asarray(cum, np.int64)

    def _decode_more(self, need: int = 1) -> bool:
        """Decode at least `need` more playable frames (one native call
        over as many packets as that takes).  False when the stream is
        exhausted.  An undecodable packet mid-stream contributes its
        nominal (TOC-derived) duration as silence and decode resumes at
        the next packet — granule alignment is preserved and one corrupt
        payload cannot truncate the rest of the track."""
        start = self._pkt
        if start >= len(self._p.packets):
            return False
        target = self._cum_ns[start] + max(need, 1) + self._skip
        j = int(np.searchsorted(self._cum_ns, target, side="left"))
        j = min(max(j, start + 1), len(self._p.packets))
        count = j - start
        cap = int(self._cum_ns[j] - self._cum_ns[start])
        out = np.empty((cap, self._p.channels), np.float32)
        used = ctypes.c_int(0)
        n = self._lib.folve_opus_decode_batch(
            self._h, self._blob,
            self._offs[start:].ctypes.data_as(ctypes.c_void_p),
            self._lens[start:].ctypes.data_as(ctypes.c_void_p),
            count, out.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(used))
        self._pkt = start + used.value
        out = out[: max(n, 0)]
        if used.value < count:
            # Packet at self._pkt refused to decode: stand in silence
            # for its nominal duration, reset the (now-desynced) decoder
            # state, skip it, and carry on.
            bad = self._pkt
            ns = int(self._cum_ns[bad + 1] - self._cum_ns[bad])
            out = np.concatenate(
                [out, np.zeros((ns, self._p.channels), np.float32)])
            self._pkt = bad + 1
            self._lib.folve_opus_reset(self._h)
        elif n <= 0:
            return False
        if self._skip > 0:
            drop = min(self._skip, out.shape[0])
            out = out[drop:]
            self._skip -= drop
        if self._p.gain != 1.0:
            out = out * np.float32(self._p.gain)
        if out.shape[0]:
            if self._pending.shape[0]:
                self._pending = np.concatenate([self._pending, out])
            else:
                self._pending = out
        return True

    def read_float(self, nframes: int) -> np.ndarray:
        take = max(0, min(nframes, self.info.frames - self._dpos))
        if take == 0:
            return np.zeros((0, self._p.channels), np.float32)
        while self._pending.shape[0] < take:
            if not self._decode_more(take - self._pending.shape[0]):
                break
        out = self._pending[:take]
        self._pending = self._pending[out.shape[0]:]
        self._dpos += out.shape[0]
        if out.shape[0] == 0:
            # Short stream (granule said more than the packets carry).
            pad = np.zeros((take, self._p.channels), np.float32)
            self._dpos += take
            return pad
        return out

    def seek(self, frame: int) -> None:
        frame = max(0, min(frame, self.info.frames))
        if frame < self._dpos:
            self._lib.folve_opus_reset(self._h)
            self._pkt = 0
            self._dpos = 0
            self._skip = self._p.pre_skip
            self._pending = np.zeros((0, self._p.channels), np.float32)
        while self._dpos < frame:
            got = self.read_float(min(frame - self._dpos, 1 << 14))
            if got.shape[0] == 0:
                break

    def close(self) -> None:
        if self._h:
            self._lib.folve_opus_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_opus(path: str) -> tuple[np.ndarray, AudioInfo]:
    src = OpusSource(path)
    try:
        out = src.read_float(src.info.frames)
        return out, src.info
    finally:
        src.close()


def read_opus_info(path: str) -> AudioInfo:
    with open(path, "rb") as f:
        blob = f.read()
    return _info(_parse(blob))
