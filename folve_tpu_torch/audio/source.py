"""Streaming decode sources — the runtime's replacement for SNDFILE*.

The reference reads input audio through libsndfile handles
(sf_readf_float in sound-processor.cc:76-84).  Here a source is any
object with ``info`` and ``read_float(nframes) -> float32 [n, ch]``;
this module provides them for WAV and FLAC.
"""

from __future__ import annotations

import io
from typing import Optional, Protocol

import numpy as np

from folve_tpu_torch.audio import sniff_container
from folve_tpu_torch.audio.types import AudioInfo, Container
from folve_tpu_torch.audio.wav import _decode_pcm, _open, _parse_header


class AudioSource(Protocol):
    info: AudioInfo

    def read_float(self, nframes: int) -> np.ndarray: ...

    def close(self) -> None: ...


class WavSource:
    """Chunked WAV reader (no full-file decode up front).

    Sample codecs (PCM/float/alaw/ulaw) stream at frame granularity;
    IMA ADPCM streams at coded-block granularity (the predictor chain
    is sequential within a block, so reads decode whole covering blocks
    and slice)."""

    def __init__(self, path_or_file, parsed=None):
        self._f = _open(path_or_file)
        if parsed is not None:
            # (info, data_offset, data_size) from a non-RIFF container
            # carrying a WAV fmt payload (Wave64) — the read logic below
            # only depends on these three.
            self.info, self._data_offset, self._data_size = parsed
        else:
            self.info, self._data_offset, self._data_size = _parse_header(self._f)
        from folve_tpu_torch.audio.types import SampleCodec

        if self.info.codec in (SampleCodec.ALAW, SampleCodec.ULAW):
            # G.711 stores one byte per sample but reports 16-bit depth.
            self._frame_bytes = self.info.channels
        else:
            self._frame_bytes = (
                self.info.channels * self.info.bits_per_sample // 8
            )
        self._pos = 0  # frames consumed

    def read_float(self, nframes: int) -> np.ndarray:
        remaining = self.info.frames - self._pos
        take = max(0, min(nframes, remaining))
        if take == 0:
            return np.zeros((0, self.info.channels), dtype=np.float32)
        if self.info.block_align:  # block-coded (IMA ADPCM)
            spb = self.info.samples_per_block
            ba = self.info.block_align
            b0 = self._pos // spb
            b1 = -(-(self._pos + take) // spb)  # ceil
            self._f.seek(self._data_offset + b0 * ba)
            raw = self._f.read(
                min((b1 - b0) * ba, self._data_size - b0 * ba)
            )
            decoded = _decode_pcm(raw, self.info)
            lo = self._pos - b0 * spb
            out = decoded[lo : lo + take]
            self._pos += out.shape[0]
            if out.shape[0] == 0:
                # Corrupt/short block that yields nothing must not wedge
                # the pump loop in an infinite retry.
                self._pos = self.info.frames
            return out
        self._f.seek(self._data_offset + self._pos * self._frame_bytes)
        raw = self._f.read(take * self._frame_bytes)
        self._pos += take
        return _decode_pcm(raw, self.info)

    def seek(self, frame: int) -> None:
        self._pos = max(0, min(frame, self.info.frames))

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class PcmChunkSource:
    """Chunked reader over a contiguous PCM payload (AIFF/AU/W64/CAF).

    Constant memory per open stream regardless of file size — like the
    reference streaming everything through libsndfile handles
    (sound-processor.cc:76-84) — where the previous ArraySource decoded
    the whole file into RAM at open (a 2-hour 24-bit W64 cost ~2 GB)."""

    def __init__(self, f, info: AudioInfo, data_offset: int,
                 frame_bytes: int, decode):
        self._f = f
        self.info = info
        self._off = data_offset
        self._frame_bytes = frame_bytes
        self._decode = decode  # whole-frame raw bytes -> float32 [n, ch]
        self._pos = 0  # frames consumed

    def read_float(self, nframes: int) -> np.ndarray:
        take = max(0, min(nframes, self.info.frames - self._pos))
        if take == 0:
            return np.zeros((0, self.info.channels), dtype=np.float32)
        self._f.seek(self._off + self._pos * self._frame_bytes)
        raw = self._f.read(take * self._frame_bytes)
        out = self._decode(raw)
        self._pos += out.shape[0]
        if out.shape[0] == 0 and take > 0:
            # Defensive: a pathological decode that makes no progress
            # must not wedge the pump loop in an infinite retry.
            self._pos = self.info.frames
        return out

    def seek(self, frame: int) -> None:
        self._pos = max(0, min(frame, self.info.frames))

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class BlockSource:
    """Block-granular source for codecs whose blocks are independent
    (AIFC 'ima4', PAF 24-bit): reads decode whole covering blocks and
    slice.  Shared so the covering-block math and the never-wedge guard
    live in exactly one place."""

    def __init__(self, f, info: AudioInfo, data_offset: int,
                 block_bytes: int, samples_per_block: int, decode):
        self._f = f
        self.info = info
        self._off = data_offset
        self._bb = block_bytes
        self._spb = samples_per_block
        self._decode = decode  # whole-block raw bytes -> float32 [n, ch]
        self._pos = 0

    def read_float(self, nframes: int) -> np.ndarray:
        take = max(0, min(nframes, self.info.frames - self._pos))
        if take == 0:
            return np.zeros((0, self.info.channels), np.float32)
        b0 = self._pos // self._spb
        b1 = -(-(self._pos + take) // self._spb)  # ceil
        self._f.seek(self._off + b0 * self._bb)
        decoded = self._decode(self._f.read((b1 - b0) * self._bb))
        out = decoded[self._pos - b0 * self._spb :][:take]
        self._pos += out.shape[0]
        if out.shape[0] == 0:
            self._pos = self.info.frames  # never wedge the pump loop
        return out

    def seek(self, frame: int) -> None:
        self._pos = max(0, min(frame, self.info.frames))

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


class _MemorySource:
    """Fallback source over a decoded array (only for multi-extent VOC
    payloads, which are tiny DOS-era files)."""

    def __init__(self, data: np.ndarray, info: AudioInfo):
        self._data = data
        self.info = info
        self._pos = 0

    def read_float(self, nframes: int) -> np.ndarray:
        take = self._data[self._pos : self._pos + nframes]
        self._pos += take.shape[0]
        return take

    def close(self) -> None:
        self._data = np.zeros((0, self.info.channels), np.float32)


class FlacSource:
    """Streaming FLAC decode source."""

    def __init__(self, path_or_bytes):
        from folve_tpu_torch.audio.flac import FlacDecoder

        self._dec = FlacDecoder(path_or_bytes)
        self.info = self._dec.info

    def read_float(self, nframes: int) -> np.ndarray:
        return self._dec.read_float(nframes)

    def close(self) -> None:
        self._dec.close()


def drain_source(src) -> "tuple[np.ndarray, AudioInfo]":
    """Read a source to exhaustion -> (float32 [n, ch], info with the
    true frame count); closes the source.  Shared by the whole-file
    readers of the streaming-only codecs (ogg/ogg-flac/mp3)."""
    chunks = []
    while True:
        blk = src.read_float(1 << 16)
        if blk.shape[0] == 0:
            break
        chunks.append(blk)
    info = src.info
    src.close()
    data = (
        np.concatenate(chunks)
        if chunks
        else np.zeros((0, info.channels), dtype=np.float32)
    )
    info.frames = data.shape[0]
    return data, info


def open_source(path: str) -> Optional[AudioSource]:
    """Open a streaming source for a file, or None if not decodable
    (the probe-and-fallback used at convolve-file-handler.cc:62-76)."""
    container = sniff_container(path)
    try:
        if container == Container.WAV:
            src = WavSource(path)
            from folve_tpu_torch.audio.types import SampleCodec

            if src.info.codec == SampleCodec.GSM610:
                # GSM state is continuous across blocks — the blockwise
                # WavSource path would decode with stale history.
                from folve_tpu_torch.audio.gsm import GsmSource

                return GsmSource(src._f, src.info, src._data_offset,
                                 src._data_size, wav49=True)
            if src.info.codec == SampleCodec.G721_32:
                # G.721-in-WAV: continuous code stream with continuous
                # predictor state — stateful source like GSM.
                from folve_tpu_torch.audio.g72x import G721_32_BITS, G72xSource

                return G72xSource(src._f, src.info, src._data_offset,
                                  src._data_size, G721_32_BITS)
            if src.info.codec in (SampleCodec.NMS_16, SampleCodec.NMS_24,
                                  SampleCodec.NMS_32):
                # NMS VBX ADPCM: predictor state is continuous across
                # the 160-sample blocks — stateful source like G.721.
                from folve_tpu_torch.audio.nms import NmsSource, type_for_codec

                return NmsSource(src._f, src.info, src._data_offset,
                                 src._data_size,
                                 type_for_codec(src.info.codec))
            if src.info.codec == SampleCodec.MP3:
                # MPEG-in-WAV: hand the data-chunk bitstream to the
                # native MPEG decoder (same whole-payload policy as a
                # bare .mp3).
                from folve_tpu_torch.audio.mp3 import Mp3Source

                src._f.seek(src._data_offset)
                raw = src._f.read(src._data_size)
                src.close()
                return Mp3Source(raw, container=Container.WAV)
            return src
        if container == Container.FLAC:
            # Pass the path: FlacDecoder reads it once into the native
            # side's copy; routing bytes through here would pin a second
            # whole-file Python buffer per open stream.
            return FlacSource(path)
        if container == Container.AIFF:
            from folve_tpu_torch.audio.aiff import open_aiff_stream

            stream = open_aiff_stream(path)
            if stream[0] is None:  # 'ima4': ready-made block source
                return stream[1]
            return PcmChunkSource(*stream)
        if container == Container.AU:
            from folve_tpu_torch.audio.au import open_au_stream

            stream = open_au_stream(path)
            if stream[0] is None:  # G.72x: ready-made stateful source
                return stream[1]
            return PcmChunkSource(*stream)
        if container == Container.W64:
            from folve_tpu_torch.audio.w64 import open_w64_stream

            # Always a ready-made source: WavSource over the parsed
            # GUID chunks, or the stateful GSM/G.721 sources.
            return open_w64_stream(path)
        if container == Container.CAF:
            from folve_tpu_torch.audio.caf import open_caf_stream

            stream = open_caf_stream(path)
            if stream[0] is None:  # ALAC: ready-made packet source
                return stream[1]
            return PcmChunkSource(*stream)
        if container == Container.OGG:
            from folve_tpu_torch.audio.oggflac import OggFlacSource, sniff_ogg_codec

            codec = sniff_ogg_codec(path)
            if codec == "flac":
                return OggFlacSource(path)
            if codec == "opus":
                from folve_tpu_torch.audio.opus import OpusSource

                return OpusSource(path)
            from folve_tpu_torch.audio.ogg import OggSource

            return OggSource(path)
        if container == Container.MP3:
            from folve_tpu_torch.audio.mp3 import Mp3Source

            return Mp3Source(path)
        if container in (Container.VOC, Container.IRCAM, Container.NIST,
                         Container.SVX, Container.PVF, Container.PAF,
                         Container.AVR, Container.WVE, Container.MAT,
                         Container.HTK, Container.SDS, Container.MPC,
                         Container.SD2, Container.XI):
            from folve_tpu_torch.audio import legacy

            opener = getattr(legacy, f"open_{container.value}_stream")
            stream = opener(path)
            if stream is not None:
                if stream[0] is None:  # ready-made block source (PAF24)
                    return stream[1]
                return PcmChunkSource(*stream)
            # multi-extent VOC payloads: small legacy files, whole read
            from folve_tpu_torch.audio import read_audio

            data, info = read_audio(path)
            return _MemorySource(data, info)
    except Exception:
        return None
    return None
