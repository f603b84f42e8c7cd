"""Ogg-encapsulated FLAC (the FLAC-to-Ogg mapping).

The reference decodes these through libsndfile's SF_FORMAT_OGG |
SF_FORMAT_FLAC path (probe at convolve-file-handler.cc:62-76); here the
Ogg page layer is unwrapped in Python and the payload handed to the
in-repo native FLAC decoder: the mapping's packets are exactly a native
FLAC stream cut at metadata-block/frame boundaries, so reassembly is
byte concatenation plus fixing the last-metadata-block flag.

Mapping (from the FLAC specification, "FLAC to Ogg mapping"):
  packet 0: 0x7F 'FLAC' major minor nheaders(2, BE) 'fLaC' STREAMINFO
  packets 1..nheaders: one metadata block each
  remaining packets: one FLAC frame each
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec


class OggFlacError(ValueError):
    pass


def _iter_packets(blob: bytes, want_serial: Optional[int]) -> Iterator[bytes]:
    """Assemble Ogg packets (lacing values; a 255 segment continues into
    the next one, possibly across pages).  Only the stream with serial
    ``want_serial`` is yielded (None = the first stream seen).  Page
    CRCs are not verified — every byte of the payload is covered by the
    FLAC layer's own CRC-8/CRC-16."""
    pos = 0
    partial = b""
    serial_filter = want_serial
    n = len(blob)
    while pos + 27 <= n:
        if blob[pos : pos + 4] != b"OggS":
            pos += 1  # resync like the native Ogg layer
            continue
        serial = struct.unpack("<I", blob[pos + 14 : pos + 18])[0]
        nseg = blob[pos + 26]
        seg_table = blob[pos + 27 : pos + 27 + nseg]
        if len(seg_table) < nseg:
            break
        body = pos + 27 + nseg
        page_len = sum(seg_table)
        if body + page_len > n:
            break
        if serial_filter is None:
            serial_filter = serial
        if serial == serial_filter:
            for lac in seg_table:
                partial += blob[body : body + lac]
                body += lac
                if lac < 255:
                    yield partial
                    partial = b""
        else:
            body += page_len
        pos = body
    # An unterminated trailing packet (truncated file) is dropped; the
    # frames recovered so far still decode.


def sniff_ogg_codec(path: str) -> Optional[str]:
    """'flac' | 'vorbis' | 'opus' | None from the first Ogg BOS packet."""
    try:
        with open(path, "rb") as f:
            head = f.read(512)
    except OSError:
        return None
    if head[:4] != b"OggS" or len(head) < 28:
        return None
    nseg = head[26]
    body = 27 + nseg
    first = head[body : body + 16]
    if first[:5] == b"\x7fFLAC":
        return "flac"
    if first[:7] == b"\x01vorbis":
        return "vorbis"
    if first[:8] == b"OpusHead":
        return "opus"
    return None


def extract_flac_stream(blob: bytes) -> bytes:
    """Reassemble the native FLAC byte stream from an Ogg-FLAC file."""
    packets = _iter_packets(blob, None)
    try:
        first = next(packets)
    except StopIteration:
        raise OggFlacError("no ogg packets") from None
    if len(first) < 51 or first[:5] != b"\x7fFLAC":
        raise OggFlacError("not an ogg-flac stream")
    # first[5]=major, first[6]=minor, first[7:9]=nheaders (big-endian),
    # then the native 'fLaC' magic + STREAMINFO block.
    (nheaders,) = struct.unpack(">H", first[7:9])
    native = first[9:]
    if native[:4] != b"fLaC":
        raise OggFlacError("mapping payload lacks fLaC magic")
    out = bytearray(native)
    streaminfo_hdr = 4  # offset of the STREAMINFO block header in out
    last_meta_hdr = streaminfo_hdr
    meta_seen = 0
    frames = bytearray()
    for pkt in packets:
        if meta_seen < nheaders:
            last_meta_hdr = len(out)
            out += pkt
            meta_seen += 1
        elif not pkt:
            continue
        elif meta_seen >= nheaders and pkt[0] == 0xFF:
            frames += pkt
        elif (pkt[0] & 0x7F) <= 6 and not frames:
            # nheaders understated (some muxers write 0): metadata
            # blocks keep arriving until the first frame.
            last_meta_hdr = len(out)
            out += pkt
        # anything else: garbage packet, skip (FLAC CRC guards frames)
    # Exactly one metadata block may carry the last-block flag; the Ogg
    # packets' copies are written for streaming and may have it unset
    # (or set on STREAMINFO when extra blocks follow).
    for off in {streaminfo_hdr, last_meta_hdr}:
        if off < len(out):
            out[off] &= 0x7F
    out[last_meta_hdr] |= 0x80
    return bytes(out) + bytes(frames)


class OggFlacSource:
    """Streaming source over the re-assembled FLAC stream."""

    def __init__(self, path: str):
        from folve_tpu_torch.audio.flac import FlacDecoder

        with open(path, "rb") as f:
            blob = f.read()
        self._dec = FlacDecoder(extract_flac_stream(blob))
        inner = self._dec.info
        self.info = AudioInfo(
            rate=inner.rate,
            channels=inner.channels,
            frames=inner.frames,
            container=Container.OGG,
            codec=SampleCodec.FLAC,
            bits_per_sample=inner.bits_per_sample,
        )

    def read_float(self, nframes: int) -> np.ndarray:
        return self._dec.read_float(nframes)

    def close(self) -> None:
        self._dec.close()


def read_ogg_flac(path: str) -> tuple[np.ndarray, AudioInfo]:
    from folve_tpu_torch.audio.source import drain_source

    return drain_source(OggFlacSource(path))


def read_ogg_flac_info(path: str) -> AudioInfo:
    src = OggFlacSource(path)
    info = src.info
    src.close()
    return info


def read_ogg_flac_metadata(path: str) -> dict:
    """VORBIS_COMMENT tags riding the mapping's metadata packets."""
    try:
        from folve_tpu_torch.audio.flac import read_flac_metadata

        with open(path, "rb") as f:
            blob = f.read()
        return read_flac_metadata(extract_flac_stream(blob)) or {}
    except Exception:
        return {}
