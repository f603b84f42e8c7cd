"""RIFF/WAVE codec (numpy, no external audio libraries).

Replaces the libsndfile WAV paths the reference leans on (IR loading via
zita-audiofile.cc, output encoding via conversion-buffer.cc's virtual IO).
Float conversion conventions match libsndfile so filter gains stay
bit-comparable: integer PCM maps to [-1, 1) by dividing by 2^(bits-1);
float->PCM writes scale by 2^(bits-1) and clip.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Union

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_MS_ADPCM = 0x0002
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_ALAW = 0x0006
_WAVE_FORMAT_MULAW = 0x0007
_WAVE_FORMAT_IMA_ADPCM = 0x0011  # a.k.a. DVI ADPCM
_WAVE_FORMAT_GSM610 = 0x0031  # Microsoft GSM 6.10 (WAV49 framing)
_WAVE_FORMAT_NMS_VBXADPCM = 0x0038  # NMS VBX ADPCM (16/24/32 kbps)
_WAVE_FORMAT_G721_ADPCM = 0x0040  # CCITT G.721 32 kbps (continuous 4-bit)
_WAVE_FORMAT_MPEG = 0x0050  # MPEG-1 Layer I/II bitstream in data chunk
_WAVE_FORMAT_MPEGLAYER3 = 0x0055
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    pass


def _open(src: Union[str, bytes, BinaryIO]) -> BinaryIO:
    if isinstance(src, str):
        return open(src, "rb")
    if isinstance(src, (bytes, bytearray)):
        return io.BytesIO(src)
    return src


def read_wav_info(src) -> AudioInfo:
    f = _open(src)
    info, offset, size = _parse_header(f)
    if info.codec == SampleCodec.MP3:
        # fmt/fact lie or are absent for MPEG-in-WAV; the bitstream is
        # authoritative (the native opener's frame-header walk is fast).
        from folve_tpu_torch.audio.mp3 import Mp3Source

        f.seek(offset)
        src2 = Mp3Source(f.read(size), container=Container.WAV)
        info = src2.info
        src2.close()
    return info


def _parse_header(f: BinaryIO):
    riff = f.read(12)
    if len(riff) < 12 or riff[8:12] != b"WAVE" or riff[:4] not in (
        b"RIFF", b"RF64", b"BW64",
    ):
        raise WavError("not a RIFF/WAVE file")
    # RF64 (EBU Tech 3306; BW64 is its broadcast successor): the 32-bit
    # RIFF/data sizes are 0xFFFFFFFF sentinels and the true 64-bit sizes
    # live in a mandatory leading ds64 chunk — what libsndfile gives the
    # reference for >4 GB captures (convolve-file-handler.cc:62-76).
    is_rf64 = riff[:4] != b"RIFF"
    ds64_data_size = None
    fmt = None
    data_offset = None
    data_size = None
    fact_frames = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fact" and size >= 4:
            body = f.read(size)
            fact_frames = struct.unpack("<I", body[:4])[0]
        elif cid == b"ds64":
            ds64 = f.read(size)
            if len(ds64) < 16:
                raise WavError("ds64 chunk too short")
            ds64_data_size = struct.unpack("<Q", ds64[8:16])[0]
        elif cid == b"fmt ":
            fmt = f.read(size)
        elif cid == b"data":
            if size == 0xFFFFFFFF and is_rf64:
                if ds64_data_size is None:
                    raise WavError("RF64 data chunk before ds64")
                size = ds64_data_size
            data_offset = f.tell()
            data_size = size
            f.seek(size + (size & 1), io.SEEK_CUR)
            continue
        else:
            f.seek(size + (size & 1), io.SEEK_CUR)
            continue
        if size & 1:
            f.seek(1, io.SEEK_CUR)
    if fmt is None or data_offset is None:
        raise WavError("missing fmt or data chunk")
    # Clamp to the actual bytes present: recorders write inflated or
    # 0xFFFFFFFF "unknown length" data sizes, and truncated files must
    # short-decode gracefully rather than crash in np.frombuffer.
    try:
        file_end = f.seek(0, io.SEEK_END)
        if data_offset + data_size > file_end or (
            data_size == 0xFFFFFFFF and not is_rf64
        ):
            data_size = max(0, file_end - data_offset)
    except OSError:
        pass  # unseekable: trust the header
    info = interpret_fmt(fmt, data_size, fact_frames)
    return info, data_offset, data_size


# GUID remainder (bytes 4..16 of the WAVEX SubFormat) of the ambisonic
# B-format family 0000000X-0721-11d3-8644-C8C1CA000000 — the marking
# the reference reads via SFC_WAVEX_GET_AMBISONIC
# (zita-audiofile.cc:72-73).
_AMBISONIC_GUID_TAIL = bytes.fromhex("2107d3118644c8c1ca000000")


def interpret_fmt(fmt: bytes, data_size: int, fact_frames=None,
                  container: Container = Container.WAV,
                  allow_mpeg: bool = True) -> AudioInfo:
    """WAVEFORMAT(EX[TENSIBLE]) fmt-chunk bytes -> AudioInfo.

    Shared by the RIFF/RF64 parser above and the Wave64 reader (Wave64
    carries a byte-identical fmt payload behind GUID chunk framing), so
    every WAV sample codec — PCM/float/G.711/IMA/MS-ADPCM/GSM/G.721 —
    is decoded identically in both containers, like libsndfile's shared
    wav_w64 fmt parser gives the reference."""
    info = _interpret_fmt_inner(fmt, data_size, fact_frames, container,
                                allow_mpeg)
    if (len(fmt) >= 40
            and struct.unpack("<H", fmt[:2])[0] == _WAVE_FORMAT_EXTENSIBLE
            and fmt[28:40] == _AMBISONIC_GUID_TAIL):
        info.ambisonic = True
    return info


def _interpret_fmt_inner(fmt: bytes, data_size: int, fact_frames=None,
                         container: Container = Container.WAV,
                         allow_mpeg: bool = True) -> AudioInfo:
    if len(fmt) < 16:
        raise WavError("fmt chunk too short")
    tag, channels, rate, _, block_align, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 40:
            raise WavError("extensible fmt chunk too short")
        tag = struct.unpack("<H", fmt[24:26])[0]
    if channels == 0 or block_align == 0:
        raise WavError("bad channel count or block alignment")
    samples_per_block = 0
    codec_params = ()
    if tag == _WAVE_FORMAT_PCM:
        codec = {8: SampleCodec.PCM_U8, 16: SampleCodec.PCM_16,
                 24: SampleCodec.PCM_24, 32: SampleCodec.PCM_32}.get(bits)
        if codec is None:
            raise WavError(f"unsupported PCM bit depth {bits}")
    elif tag == _WAVE_FORMAT_IEEE_FLOAT:
        codec = {32: SampleCodec.FLOAT, 64: SampleCodec.DOUBLE}.get(bits)
        if codec is None:
            raise WavError(f"unsupported float bit depth {bits}")
    elif tag == _WAVE_FORMAT_ALAW:
        codec = SampleCodec.ALAW
        bits = 16  # G.711 decodes to 16-bit range (same as the AU reader)
    elif tag == _WAVE_FORMAT_MULAW:
        codec = SampleCodec.ULAW
        bits = 16
    elif tag == _WAVE_FORMAT_MS_ADPCM:
        codec = SampleCodec.MS_ADPCM
        if bits != 4:
            raise WavError(f"MS ADPCM bits {bits} != 4")
        if block_align < 7 * channels + channels:
            raise WavError("MS ADPCM block too small")
        derived = (block_align - 7 * channels) * 2 // channels + 2
        # fmt extension: cbSize(2) + wSamplesPerBlock(2) +
        # wNumCoef(2) + aCoef pairs (int16 x 2 each).
        ncoef = 0
        if len(fmt) >= 22:
            samples_per_block = struct.unpack("<H", fmt[18:20])[0]
            ncoef = struct.unpack("<H", fmt[20:22])[0]
        if not (2 <= samples_per_block <= derived):
            samples_per_block = derived
        pairs = []
        for i in range(min(ncoef, 64)):
            off = 22 + i * 4
            if off + 4 > len(fmt):
                break
            pairs.append(struct.unpack("<hh", fmt[off : off + 4]))
        if not pairs:  # the standard seven predictor pairs
            pairs = [(256, 0), (512, -256), (0, 0), (192, 64), (240, 0),
                     (460, -208), (392, -232)]
        codec_params = tuple(pairs)
    elif tag == _WAVE_FORMAT_IMA_ADPCM:
        codec = SampleCodec.IMA_ADPCM
        if bits != 4:
            raise WavError(f"IMA ADPCM bits {bits} != 4")
        if block_align < 4 * channels + 4:
            raise WavError("IMA ADPCM block too small")
        # fmt extension: cbSize(2) + wSamplesPerBlock(2).  Derive from
        # the block size when absent (the canonical relation), capped at
        # what the whole 4-bytes-per-channel nibble groups can carry —
        # a block size that is not header + k*4*ch leaves trailing bytes
        # no decoder reads, and an uncapped spb would over-run the
        # nibble array.
        groups = (block_align - 4 * channels) // (4 * channels)
        derived = groups * 8 + 1
        if len(fmt) >= 20:
            samples_per_block = struct.unpack("<H", fmt[18:20])[0]
        if not (1 <= samples_per_block <= derived):
            samples_per_block = derived
    elif tag == _WAVE_FORMAT_GSM610:
        codec = SampleCodec.GSM610
        bits = 16  # fmt declares 0 bits; decode is 16-bit
        if channels != 1:
            raise WavError("GSM 6.10 is mono-only")
        if block_align != 65:
            raise WavError(f"GSM 6.10 block align {block_align} != 65")
        samples_per_block = 320
    elif tag == _WAVE_FORMAT_NMS_VBXADPCM:
        # 160-sample blocks of 42/62/82 bytes; the fmt bit width (2/3/4)
        # selects the 16/24/32 kbps rate (native/nms_codec.cc).
        codec = {2: SampleCodec.NMS_16, 3: SampleCodec.NMS_24,
                 4: SampleCodec.NMS_32}.get(bits)
        if codec is None:
            raise WavError(f"NMS ADPCM bit width {bits} not 2/3/4")
        if channels != 1:
            raise WavError("NMS ADPCM is mono-only")
        bits = 16  # decode is 16-bit range
    elif tag == _WAVE_FORMAT_G721_ADPCM:
        # The data chunk is ONE continuous 4-bit code stream (the
        # nominal 64-byte block align carries no framing and the
        # predictor state runs across it — probed in
        # tools/g72x_probe.py).
        codec = SampleCodec.G721_32
        if channels != 1:
            raise WavError("G.721 is mono-only")
        bits = 16  # fmt declares 4 coded bits; decode is 16-bit
    elif tag in (_WAVE_FORMAT_MPEG, _WAVE_FORMAT_MPEGLAYER3) and allow_mpeg:
        # MPEG audio bitstream in the data chunk (libsndfile 1.1
        # decodes these for the reference).  Authoritative rate /
        # channels / frames come from the bitstream itself, not the
        # fmt chunk — callers re-probe via Mp3Source.
        codec = SampleCodec.MP3
        bits = 16
    else:
        raise WavError(f"unsupported WAVE format tag 0x{tag:04x}")

    if codec == SampleCodec.MP3:
        return AudioInfo(
            rate=rate, channels=channels, frames=fact_frames or 0,
            container=container, codec=codec, bits_per_sample=bits,
        )

    if codec == SampleCodec.GSM610:
        # Blockwise ceil — a partial tail block decodes zero-padded
        # (matches the libsndfile behavior the reference inherits;
        # the fact chunk is ignored, probed in tests/test_gsm.py).
        frames = -(-data_size // block_align) * samples_per_block
        del fact_frames
        return AudioInfo(
            rate=rate, channels=channels, frames=frames,
            container=container, codec=codec, bits_per_sample=bits,
            block_align=block_align, samples_per_block=samples_per_block,
        )

    if codec == SampleCodec.G721_32:
        # Continuous sub-byte stream; the fact chunk is ignored like
        # the other coded formats (data-derived count, two codes/byte).
        del fact_frames
        return AudioInfo(
            rate=rate, channels=1, frames=data_size * 2,
            container=container, codec=codec, bits_per_sample=bits,
        )

    if codec in (SampleCodec.NMS_16, SampleCodec.NMS_24,
                 SampleCodec.NMS_32):
        # Blockwise ceil like the oracle (a truncated final block
        # decodes zero-padded to a full 160 samples); fact is ignored.
        from folve_tpu_torch.audio.nms import (BLOCK_BYTES, nms_frames_in,
                                         type_for_codec)

        rate_type = type_for_codec(codec)
        del fact_frames
        return AudioInfo(
            rate=rate, channels=1, frames=nms_frames_in(data_size, rate_type),
            container=container, codec=codec, bits_per_sample=bits,
            block_align=BLOCK_BYTES[rate_type], samples_per_block=160,
        )

    block_coded = codec in (SampleCodec.IMA_ADPCM, SampleCodec.MS_ADPCM)
    if block_coded:
        hdr_bytes = (4 if codec == SampleCodec.IMA_ADPCM else 7) * channels
        hdr_samples = 1 if codec == SampleCodec.IMA_ADPCM else 2
        full_blocks, rem = divmod(data_size, block_align)
        frames = full_blocks * samples_per_block
        if rem > hdr_bytes:
            frames += min(samples_per_block,
                          hdr_samples + (rem - hdr_bytes) * 2 // channels)
        elif rem >= hdr_bytes:
            frames += hdr_samples  # header-only partial block
        # NOTE: the fact chunk is deliberately ignored for ADPCM —
        # libsndfile (the behavior the reference inherits) decodes whole
        # blocks and reports the block total; its own writer even emits
        # a fact value inconsistent with both the input and the blocks.
        del fact_frames
    else:
        # Simple sample codecs: frame size comes from channels x the
        # codec's storage width, like libsndfile's computed blockwidth.
        # The declared block_align is NOT trusted here — a corrupt
        # value would mis-size the stream (wrong frame count, reads
        # past the data chunk) while libsndfile decodes it fine.
        storage = {
            SampleCodec.PCM_U8: 1, SampleCodec.PCM_16: 2,
            SampleCodec.PCM_24: 3, SampleCodec.PCM_32: 4,
            SampleCodec.FLOAT: 4, SampleCodec.DOUBLE: 8,
            SampleCodec.ALAW: 1, SampleCodec.ULAW: 1,
        }[codec]
        frames = data_size // (channels * storage)
    return AudioInfo(
        rate=rate,
        channels=channels,
        frames=frames,
        container=container,
        codec=codec,
        bits_per_sample=bits,
        block_align=block_align if block_coded else 0,
        samples_per_block=samples_per_block,
        codec_params=codec_params,
    )


# IMA/DVI ADPCM tables (IMA ADPCM Reference Algorithm, 1992).
_IMA_INDEX_TABLE = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32
)
_IMA_STEP_TABLE = np.array(
    [7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
     41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
     190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
     724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
     2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
     6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
     16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32
)


def _decode_ima_adpcm(raw: bytes, info: AudioInfo) -> np.ndarray:
    """IMA ADPCM data bytes (whole blocks, possibly a short tail block)
    -> float32 [n, ch].  The predictor chain is sequential WITHIN a
    block, but blocks are independent, so the loop runs over the sample
    index with every block x channel decoded as one vector step."""
    ch = info.channels
    ba = info.block_align
    spb = info.samples_per_block
    if ba <= 0 or spb <= 0:
        raise WavError("IMA ADPCM without block geometry")
    nb_full, rem = divmod(len(raw), ba)
    tail_samples = 0
    if rem > 4 * ch:
        tail_samples = min(spb, 1 + (rem - 4 * ch) * 2 // ch)
    elif rem >= 4 * ch:
        tail_samples = 1
    if rem and tail_samples:
        # Zero-pad the short tail to a full block; extra decoded samples
        # are sliced off below.
        raw = raw[: nb_full * ba] + raw[nb_full * ba:] + b"\0" * (ba - rem)
        nb = nb_full + 1
    else:
        raw = raw[: nb_full * ba]
        nb = nb_full
    if nb == 0:
        return np.zeros((0, ch), np.float32)
    blocks = np.frombuffer(raw, np.uint8).reshape(nb, ba)
    hdr = blocks[:, : 4 * ch].reshape(nb, ch, 4)
    pred = hdr[:, :, 0].astype(np.int32) | (hdr[:, :, 1].astype(np.int32) << 8)
    pred = np.where(pred >= 32768, pred - 65536, pred)
    index = np.clip(hdr[:, :, 2].astype(np.int32), 0, 88)
    data = blocks[:, 4 * ch:]
    ngroups = data.shape[1] // (4 * ch)
    data = data[:, : ngroups * 4 * ch].reshape(nb, ngroups, ch, 4)
    # Nibble order per byte: low first, then high.
    nibs = np.empty((nb, ngroups, ch, 8), np.uint8)
    nibs[..., 0::2] = data & 0x0F
    nibs[..., 1::2] = data >> 4
    nibs = nibs.transpose(0, 2, 1, 3).reshape(nb, ch, ngroups * 8)
    out = np.empty((nb, ch, spb), np.int32)
    out[:, :, 0] = pred
    for s in range(1, spb):
        nib = nibs[:, :, s - 1].astype(np.int32)
        step = _IMA_STEP_TABLE[index]
        # Exact bit-serial magnitude (NOT ((2m+1)*step)>>4 — the shifts
        # truncate differently and decoders must match bit-for-bit).
        diff = step >> 3
        diff = diff + np.where(nib & 4, step, 0)
        diff = diff + np.where(nib & 2, step >> 1, 0)
        diff = diff + np.where(nib & 1, step >> 2, 0)
        pred = np.where(nib & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        index = np.clip(index + _IMA_INDEX_TABLE[nib], 0, 88)
        out[:, :, s] = pred
    x = out.transpose(0, 2, 1).reshape(-1, ch).astype(np.float32) / 32768.0
    n = nb_full * spb + tail_samples
    return x[:n]


_MS_ADAPT = np.array(
    [230, 230, 230, 230, 307, 409, 512, 614, 768, 614, 512, 409, 307,
     230, 230, 230], np.int32
)


def _decode_ms_adpcm(raw: bytes, info: AudioInfo) -> np.ndarray:
    """MS ADPCM (WAVE tag 0x0002) -> float32 [n, ch].  Like the IMA
    decoder, the adaptive predictor is sequential within a block but
    blocks are independent, so the loop runs over the in-block sample
    index with all blocks x channels as one vector step."""
    ch = info.channels
    ba = info.block_align
    spb = info.samples_per_block
    if ba <= 0 or spb <= 1:
        raise WavError("MS ADPCM without block geometry")
    coefs = np.array(info.codec_params or [(256, 0)], np.int32)
    nb_full, rem = divmod(len(raw), ba)
    hdr = 7 * ch
    tail_samples = 0
    if rem > hdr:
        tail_samples = min(spb, 2 + (rem - hdr) * 2 // ch)
    elif rem >= hdr:
        tail_samples = 2
    if rem and tail_samples:
        raw = raw[: nb_full * ba] + raw[nb_full * ba:] + b"\0" * (ba - rem)
        nb = nb_full + 1
    else:
        raw = raw[: nb_full * ba]
        nb = nb_full
    if nb == 0:
        return np.zeros((0, ch), np.float32)
    blocks = np.frombuffer(raw, np.uint8).reshape(nb, ba)
    # Header layout: predictor index per channel (1 byte each), then
    # initial delta (int16 LE per channel), sample1, sample2.
    pred_idx = np.clip(blocks[:, :ch].astype(np.int32), 0, len(coefs) - 1)
    def i16(off):
        lo = blocks[:, off : off + 2 * ch : 2].astype(np.int32)
        hi = blocks[:, off + 1 : off + 1 + 2 * ch : 2].astype(np.int32)
        v = lo | (hi << 8)
        return np.where(v >= 32768, v - 65536, v)
    delta = i16(ch)
    s1 = i16(3 * ch)
    s2 = i16(5 * ch)
    c1 = coefs[pred_idx, 0]
    c2 = coefs[pred_idx, 1]
    data = blocks[:, hdr:]
    # Nibble stream: high nibble first, channels round-robin per nibble.
    nibs = np.empty((nb, data.shape[1] * 2), np.uint8)
    nibs[:, 0::2] = data >> 4
    nibs[:, 1::2] = data & 0x0F
    out = np.empty((nb, spb, ch), np.int32)
    out[:, 0, :] = s2  # sample2 is the OLDER of the two header samples
    if spb > 1:
        out[:, 1, :] = s1
    for s in range(2, spb):
        base = (s - 2) * ch
        nib = nibs[:, base : base + ch].astype(np.int32)
        signed = np.where(nib >= 8, nib - 16, nib)
        pred = ((s1 * c1 + s2 * c2) >> 8) + signed * delta
        pred = np.clip(pred, -32768, 32767)
        s2 = s1
        s1 = pred
        delta = np.maximum((_MS_ADAPT[nib] * delta) >> 8, 16)
        out[:, s, :] = pred
    x = out.reshape(-1, ch).astype(np.float32) / 32768.0
    n = nb_full * spb + tail_samples
    return x[:n]


def _decode_pcm(raw: bytes, info: AudioInfo) -> np.ndarray:
    ch = info.channels
    c = info.codec
    if c == SampleCodec.IMA_ADPCM:
        return _decode_ima_adpcm(raw, info)
    if c == SampleCodec.MS_ADPCM:
        return _decode_ms_adpcm(raw, info)
    if c == SampleCodec.GSM610:
        from folve_tpu_torch.audio.gsm import decode_gsm

        return decode_gsm(raw, wav49=True)
    if c == SampleCodec.G721_32:
        from folve_tpu_torch.audio.g72x import G721_32_BITS, decode_g72x

        return decode_g72x(raw, G721_32_BITS)
    if c in (SampleCodec.NMS_16, SampleCodec.NMS_24, SampleCodec.NMS_32):
        from folve_tpu_torch.audio.nms import decode_nms, type_for_codec

        return decode_nms(raw, type_for_codec(c))
    if c == SampleCodec.PCM_16:
        x = np.frombuffer(raw[: len(raw) - len(raw) % 2], dtype="<i2").astype(np.float32) / 32768.0
    elif c == SampleCodec.PCM_24:
        b = np.frombuffer(raw[: len(raw) - len(raw) % 3], dtype=np.uint8)
        b = b.reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = (val << 8) >> 8  # sign-extend 24 -> 32
        x = val.astype(np.float32) / 8388608.0
    elif c == SampleCodec.PCM_32:
        x = np.frombuffer(raw[: len(raw) - len(raw) % 4], dtype="<i4").astype(np.float32) / 2147483648.0
    elif c == SampleCodec.PCM_U8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif c == SampleCodec.FLOAT:
        x = np.frombuffer(raw[: len(raw) - len(raw) % 4], dtype="<f4").astype(np.float32)
    elif c == SampleCodec.DOUBLE:
        x = np.frombuffer(raw[: len(raw) - len(raw) % 8], dtype="<f8").astype(np.float32)
    elif c == SampleCodec.ULAW:
        from folve_tpu_torch.audio.au import _mulaw_table

        x = _mulaw_table()[np.frombuffer(raw, np.uint8)].astype(np.float32) / 32768.0
    elif c == SampleCodec.ALAW:
        from folve_tpu_torch.audio.au import _alaw_table

        x = _alaw_table()[np.frombuffer(raw, np.uint8)].astype(np.float32) / 32768.0
    else:
        raise WavError(f"cannot decode codec {c}")
    n = (len(x) // ch) * ch
    return x[:n].reshape(-1, ch)


# RIFF LIST/INFO tag ids -> vorbis-comment-ish field names (the
# reference copies these via sf_get_string/sf_set_string,
# convolve-file-handler.cc:484-495).
_INFO_TAGS = {
    b"INAM": "TITLE",
    b"IART": "ARTIST",
    b"IPRD": "ALBUM",
    b"ICRD": "DATE",
    b"ICMT": "COMMENT",
    b"IGNR": "GENRE",
    b"ITRK": "TRACKNUMBER",
    b"ICOP": "COPYRIGHT",
    b"ISFT": "SOFTWARE",
}


def read_wav_metadata(src) -> dict:
    """String tags from the LIST/INFO chunk, keyed by vorbis-style names."""
    f = _open(src)
    out = {}
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] not in (b"RIFF", b"RF64", b"BW64"):
        return out
    ds64_data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"ds64":
            ds64 = f.read(size + (size & 1))
            if len(ds64) >= 16:
                ds64_data_size = struct.unpack("<Q", ds64[8:16])[0]
            continue
        if cid == b"data" and size == 0xFFFFFFFF and ds64_data_size is not None:
            # RF64 sentinel: the real 64-bit size came from ds64.
            size = ds64_data_size
        if cid == b"LIST":
            body = f.read(size)
            if body[:4] == b"INFO":
                pos = 4
                while pos + 8 <= len(body):
                    tag = body[pos : pos + 4]
                    tlen = struct.unpack("<I", body[pos + 4 : pos + 8])[0]
                    val = body[pos + 8 : pos + 8 + tlen].split(b"\0")[0]
                    name = _INFO_TAGS.get(tag)
                    if name and val:
                        out[name] = val.decode("utf-8", errors="replace")
                    pos += 8 + tlen + (tlen & 1)
        else:
            f.seek(size, io.SEEK_CUR)
        if size & 1:
            f.seek(1, io.SEEK_CUR)
    return out


def read_wav(src) -> tuple[np.ndarray, AudioInfo]:
    """Decode a whole WAV file -> (float32 [frames, channels], AudioInfo)."""
    f = _open(src)
    info, offset, size = _parse_header(f)
    f.seek(offset)
    raw = f.read(size)
    if info.codec == SampleCodec.MP3:
        from folve_tpu_torch.audio.mp3 import Mp3Source
        from folve_tpu_torch.audio.source import drain_source

        data, sinfo = drain_source(Mp3Source(raw, container=Container.WAV))
        return data, sinfo
    return _decode_pcm(raw, info), info


def _encode_pcm(x: np.ndarray, codec: SampleCodec) -> bytes:
    if codec == SampleCodec.PCM_16:
        v = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
        return v.tobytes()
    if codec == SampleCodec.PCM_24:
        v = np.clip(np.round(x * 8388608.0), -8388608, 8388607).astype(np.int32)
        out = np.empty((v.size, 3), dtype=np.uint8)
        flat = v.reshape(-1)
        out[:, 0] = flat & 0xFF
        out[:, 1] = (flat >> 8) & 0xFF
        out[:, 2] = (flat >> 16) & 0xFF
        return out.tobytes()
    if codec == SampleCodec.PCM_32:
        v = np.clip(np.round(x * 2147483648.0), -2147483648, 2147483647).astype("<i4")
        return v.tobytes()
    if codec == SampleCodec.FLOAT:
        return x.astype("<f4").tobytes()
    if codec == SampleCodec.DOUBLE:
        return x.astype("<f8").tobytes()
    raise WavError(f"cannot encode codec {codec}")


class WavStreamEncoder:
    """Streaming PCM WAV encoder with an exact-size header (same
    FlacEncoder-shaped interface as the other PCM stream encoders)."""

    _CODECS = {16: SampleCodec.PCM_16, 24: SampleCodec.PCM_24,
               32: SampleCodec.PCM_32}

    def __init__(self, rate: int, channels: int, bits: int,
                 total_frames: int):
        if bits not in self._CODECS:
            raise WavError(f"unsupported WAV stream depth {bits}")
        self.rate = rate
        self.channels = channels
        self.bits = bits
        self.total_frames = total_frames
        self.blocksize = 0

    def header(self, metadata: Union[dict, None] = None) -> bytes:
        import io as _io

        buf = _io.BytesIO()
        # Reuse write_wav's header logic with an empty payload, then
        # patch the declared sizes for the real frame count.
        write_wav(buf, np.zeros((0, self.channels), np.float32), self.rate,
                  self._CODECS[self.bits], metadata)
        blob = bytearray(buf.getvalue())
        payload = self.total_frames * self.channels * self.bits // 8
        blob[4:8] = struct.pack("<I", len(blob) - 8 + payload)
        blob[-4:] = struct.pack("<I", payload)  # data chunk size
        return bytes(blob)

    def write_float(self, samples: np.ndarray) -> bytes:
        return _encode_pcm(np.asarray(samples, np.float64),
                           self._CODECS[self.bits])

    def write_int(self, samples: np.ndarray) -> bytes:
        scale = float(1 << (self.bits - 1))
        return self.write_float(np.asarray(samples, np.float64) / scale)

    def finish(self) -> bytes:
        return b""

    def close(self) -> None:
        pass


def write_wav(
    dst: Union[str, BinaryIO],
    data: np.ndarray,
    rate: int,
    codec: SampleCodec = SampleCodec.FLOAT,
    metadata: Union[dict, None] = None,
) -> None:
    """Encode float32 [frames, channels] to a WAV file; ``metadata`` maps
    vorbis-style field names (TITLE, ARTIST, ...) to a LIST/INFO chunk."""
    if data.ndim == 1:
        data = data[:, None]
    channels = data.shape[1]
    bits = {SampleCodec.PCM_16: 16, SampleCodec.PCM_24: 24, SampleCodec.PCM_32: 32,
            SampleCodec.FLOAT: 32, SampleCodec.DOUBLE: 64}[codec]
    tag = _WAVE_FORMAT_IEEE_FLOAT if codec in (SampleCodec.FLOAT, SampleCodec.DOUBLE) else _WAVE_FORMAT_PCM
    payload = _encode_pcm(data, codec)
    block_align = channels * bits // 8
    fmt = struct.pack(
        "<HHIIHH", tag, channels, rate, rate * block_align, block_align, bits
    )
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if metadata:
        rev = {v: k for k, v in _INFO_TAGS.items()}
        info = b"INFO"
        for name, value in metadata.items():
            tag4 = rev.get(name.upper())
            if tag4 is None:
                continue
            val = value.encode("utf-8") + b"\0"
            if len(val) & 1:
                val += b"\0"
            info += tag4 + struct.pack("<I", len(val)) + val
        body += b"LIST" + struct.pack("<I", len(info)) + info
    body += b"data" + struct.pack("<I", len(payload)) + payload
    blob = b"RIFF" + struct.pack("<I", len(body)) + body
    if isinstance(dst, str):
        with open(dst, "wb") as f:
            f.write(blob)
    else:
        dst.write(blob)
