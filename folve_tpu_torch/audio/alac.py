"""Apple Lossless (ALAC) in CAF — decode support.

The reference convolves anything libsndfile decodes
(convolve-file-handler.cc:62-76); libsndfile 1.1 bundles Apple's ALAC
codec for the CAF 'alac' format id.  The decoder here is the
from-scratch ``native/alac_codec.cc`` (bitstream semantics recovered
behaviorally and validated lossless against oracle-encoded streams —
see tools/alac_probe.py); this module parses the CAF side (kuki magic
cookie, pakt packet table) and provides the streaming source.

ALAC packets are STATELESS, so seeking is true random access on packet
boundaries — unlike GSM/MP3 there is no decode-from-start penalty.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class AlacError(ValueError):
    pass


def _lib():
    from folve_tpu_torch.utils.native_build import load_native

    lib = load_native()
    if not hasattr(lib.folve_alac_create, "_alac_ready"):
        lib.folve_alac_create.restype = ctypes.c_void_p
        lib.folve_alac_create.argtypes = [
            ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ]
        lib.folve_alac_close.argtypes = [ctypes.c_void_p]
        lib.folve_alac_decode_packet.restype = ctypes.c_int64
        lib.folve_alac_decode_packet.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_void_p,
        ]
        lib.folve_alac_create._alac_ready = True
    return lib


def parse_alac_cookie(kuki: bytes) -> dict:
    """ALACSpecificConfig from a CAF kuki chunk.  Apple CAF files carry
    the raw 24-byte config; MP4-derived cookies wrap it in an 'alac'
    atom (size + 'alac' + version) — accept both."""
    if len(kuki) >= 36 and kuki[4:8] == b"alac":
        kuki = kuki[12:]
    if len(kuki) < 24:
        raise AlacError("short ALAC magic cookie")
    (frame_length, _compat, bit_depth, pb, mb, kb, channels, max_run,
     _max_bytes, _avg_rate, rate) = struct.unpack(">IBBBBBBHIII", kuki[:24])
    if not (1 <= channels <= 16) or not (1 <= bit_depth <= 32):
        raise AlacError("bad ALAC config")
    if not (1 <= frame_length <= 1 << 20):
        raise AlacError("bad ALAC frame length")
    return dict(frame_length=frame_length, bit_depth=bit_depth, pb=pb,
                mb=mb, kb=kb, channels=channels, max_run=max_run,
                rate=rate)


def parse_pakt(body: bytes):
    """CAF packet table -> (n_valid_frames, priming, [packet sizes])."""
    if len(body) < 24:
        raise AlacError("short pakt chunk")
    n_pkts, n_valid, priming, _remainder = struct.unpack(">qqii", body[:24])
    if n_pkts < 0 or n_pkts > 1 << 40:
        raise AlacError("bad pakt count")
    sizes = []
    i = 24
    for _ in range(n_pkts):
        v = 0
        while True:
            if i >= len(body):
                raise AlacError("truncated pakt varints")
            b = body[i]
            i += 1
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                break
            if v > 1 << 40:
                raise AlacError("pakt varint overflow")
        sizes.append(v)
    return n_valid, priming, sizes


def _caf_alac_layout(f):
    """Parse an open CAF file -> (cfg, rate, data_offset, packet
    offsets/sizes, n_valid, priming).  Walks the chunk directory only —
    packet payloads are never read here."""
    f.seek(0)
    hdr = f.read(8)
    if len(hdr) < 8 or hdr[:4] != b"caff":
        raise AlacError("not a CAF file")
    f.seek(0, 2)
    total = f.tell()
    pos = 8
    rate = None
    kuki = pakt = None
    data_off = None
    while pos + 12 <= total:
        f.seek(pos)
        chdr = f.read(12)
        if len(chdr) < 12:
            break
        ctype = chdr[:4]
        (size,) = struct.unpack(">q", chdr[4:12])
        body_off = pos + 12
        if size == -1:
            size = total - body_off
        elif size < 0:
            raise AlacError(f"negative chunk size {size}")
        size = int(size)
        if ctype == b"desc":
            body = f.read(32)
            rate = struct.unpack(">d", body[:8])[0]
            if body[8:12] != b"alac":
                raise AlacError("not CAF/alac")
        elif ctype == b"kuki":
            kuki = f.read(min(size, 1 << 16))
        elif ctype == b"pakt":
            pakt = f.read(min(size, 1 << 24))
        elif ctype == b"data":
            data_off = body_off + 4  # skip edit count
        pos = body_off + size
    if rate is None or kuki is None or pakt is None or data_off is None:
        raise AlacError("missing desc/kuki/pakt/data chunks")
    cfg = parse_alac_cookie(kuki)
    n_valid, priming, sizes = parse_pakt(pakt)
    offs = []
    off = data_off
    for s in sizes:
        offs.append((off, s))
        off += s
    return cfg, int(round(rate)), offs, n_valid, priming


class AlacSource:
    """Streaming CAF/ALAC source (AudioSource protocol) with true
    packet-aligned random access."""

    def __init__(self, path_or_file):
        self._f = (open(path_or_file, "rb")
                   if isinstance(path_or_file, str) else path_or_file)
        try:
            cfg, rate, pkts, n_valid, priming = _caf_alac_layout(self._f)
        except Exception:
            self._f.close()
            raise
        self._cfg = cfg
        self._pkts = pkts
        self._priming = max(0, priming)
        self._lib = _lib()
        self._h = self._lib.folve_alac_create(
            cfg["frame_length"], cfg["bit_depth"], cfg["pb"], cfg["mb"],
            cfg["kb"], cfg["channels"])
        if not self._h:
            self._f.close()
            raise MemoryError("alac state")
        self.info = AudioInfo(
            rate=rate, channels=cfg["channels"], frames=max(0, n_valid),
            container=Container.CAF, codec=SampleCodec.ALAC,
            bits_per_sample=cfg["bit_depth"],
        )
        self._scale = np.float32(1.0 / (1 << (cfg["bit_depth"] - 1)))
        self._buf = np.empty(
            cfg["frame_length"] * cfg["channels"], np.int32)
        self._pos = 0          # frames handed out (0 = first valid frame)
        self._pkt_idx = 0      # next packet to decode
        self._pkt_base = -self._priming  # frame index of packet start
        self._pending = np.zeros((0, cfg["channels"]), np.float32)

    def _decode_next_packet(self) -> bool:
        if self._pkt_idx >= len(self._pkts):
            return False
        off, size = self._pkts[self._pkt_idx]
        self._f.seek(off)
        raw = self._f.read(size)
        self._pkt_idx += 1
        if len(raw) < size:
            self._pkt_idx = len(self._pkts)  # file shrank: stop
            if not raw:
                return False
        n = self._lib.folve_alac_decode_packet(
            self._h, raw, len(raw),
            self._buf.ctypes.data_as(ctypes.c_void_p))
        if n <= 0:
            self._pkt_idx = len(self._pkts)  # malformed: short decode
            return False
        ch = self.info.channels
        x = (self._buf[: n * ch].astype(np.float32) * self._scale
             ).reshape(-1, ch)
        start = self._pkt_base
        self._pkt_base += n
        # Clip priming frames (negative indices) and frames past the
        # valid count.
        lo = max(0, -start)
        hi = min(int(n), self.info.frames - start)
        if hi > lo:
            self._pending = np.concatenate([self._pending, x[lo:hi]])
        return True

    def read_float(self, nframes: int) -> np.ndarray:
        take = max(0, min(nframes, self.info.frames - self._pos))
        ch = self.info.channels
        if take == 0:
            return np.zeros((0, ch), np.float32)
        while self._pending.shape[0] < take:
            if not self._decode_next_packet():
                break
        out = self._pending[:take]
        self._pending = self._pending[out.shape[0]:]
        self._pos += out.shape[0]
        if out.shape[0] == 0:
            self._pos = self.info.frames  # never wedge the pump loop
        return out

    def seek(self, frame: int) -> None:
        frame = max(0, min(frame, self.info.frames))
        fl = self._cfg["frame_length"]
        # Packets are stateless: jump straight to the covering packet.
        target = frame + self._priming
        pkt = min(target // fl, len(self._pkts))
        self._pkt_idx = int(pkt)
        self._pkt_base = int(pkt) * fl - self._priming
        self._pending = np.zeros((0, self.info.channels), np.float32)
        self._pos = max(0, self._pkt_base)
        while self._pos < frame:
            skip = self.read_float(min(frame - self._pos, fl))
            if skip.shape[0] == 0:
                break

    def close(self) -> None:
        if self._h:
            self._lib.folve_alac_close(self._h)
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


def read_caf_alac(src) -> "tuple[np.ndarray, AudioInfo]":
    from folve_tpu_torch.audio.source import drain_source

    return drain_source(AlacSource(src))
