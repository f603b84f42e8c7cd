"""Audio IO: container/codec detection, decode and encode.

This package replaces the reference's libsndfile dependency with native
implementations (WAV here, FLAC in ``folve_tpu_torch.audio.flac``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from folve_tpu_torch.audio.types import AudioInfo, Container, SampleCodec
from folve_tpu_torch.audio.wav import WavError, read_wav, read_wav_info, write_wav


def sniff_container(path: str) -> Optional[Container]:
    """Detect the container from file magic (the reference probes with
    sf_open_fd, convolve-file-handler.cc:62-76; we sniff directly)."""
    try:
        with open(path, "rb") as f:
            magic = f.read(12)
    except OSError:
        return None
    if (
        len(magic) >= 12
        and magic[:4] in (b"RIFF", b"RF64", b"BW64")
        and magic[8:12] == b"WAVE"
    ):
        return Container.WAV
    if magic[:4] == b"fLaC":
        return Container.FLAC
    if magic[:4] == b"OggS":
        return Container.OGG
    if magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return Container.AIFF
    if magic[:4] == b".snd":
        return Container.AU
    if magic[:4] == b"riff":  # Wave64's GUID begins with lowercase riff
        from folve_tpu_torch.audio.w64 import GUID_RIFF

        try:
            with open(path, "rb") as f:
                head = f.read(16)
        except OSError:
            return None
        if head == GUID_RIFF:
            return Container.W64
        return None
    if magic[:4] == b"caff":
        return Container.CAF
    if magic[:12] == b"Creative Voi":
        return Container.VOC
    # IRCAM magics: 0x64A3 machine variants, either byte order
    if (magic[:2] == b"\x64\xa3" and magic[2] in b"\x01\x02\x03\x04"
            and magic[3] == 0) or (
            magic[2:4] == b"\xa3\x64" and magic[1] in b"\x01\x02\x03\x04"
            and magic[0] == 0):
        return Container.IRCAM
    if magic[:8] == b"NIST_1A\n":
        return Container.NIST
    if magic[:4] == b"FORM" and magic[8:12] in (b"8SVX", b"16SV"):
        return Container.SVX
    if magic[:5] == b"PVF1\n":
        return Container.PVF
    if magic[:4] in (b" paf", b"fap "):
        return Container.PAF
    if magic[:4] == b"2BIT":
        return Container.AVR
    if magic[:12] == b"ALawSoundFil":  # "ALawSoundFile**"
        return Container.WVE
    if magic[:6] == b"MATLAB":  # MAT5 text header
        return Container.MAT
    # MAT4: first element header is type=0 (LE double), 1x1 "samplerate"
    if magic[:8] == b"\x00\x00\x00\x00\x01\x00\x00\x00":
        try:
            with open(path, "rb") as f:
                head = f.read(31)
        except OSError:
            return None
        if head[16:20] == b"\x0b\x00\x00\x00" and \
                head[20:30] == b"samplerate":
            return Container.MAT
        return None
    if magic[:2] == b"\xf0\x7e" and len(magic) >= 4 and magic[3] == 0x01:
        return Container.SDS  # MIDI sample-dump header packet
    if magic[:12] == b"Extended Ins":  # "Extended Instrument: " (XI)
        return Container.XI
    # HTK and MPC2000 have weak/no magic: both checks demand a fully
    # size-consistent header, so run them before the MP3 sync scan.
    if len(magic) >= 12:
        import os
        import struct

        try:
            total = os.path.getsize(path)
        except OSError:
            return None
        nsamp, period, samp_size, parm_kind = struct.unpack(
            ">IIHH", magic[:12]
        )
        if (parm_kind == 0 and samp_size == 2 and period
                and nsamp * 2 + 12 == total
                and 100 <= round(1e7 / period) <= 400000):
            return Container.HTK
        if magic[0] == 1 and magic[1] == 4 and total >= 42:
            try:
                with open(path, "rb") as f:
                    head = f.read(42)
            except OSError:
                return None
            channels = 2 if head[21] else 1
            (frames,) = struct.unpack("<I", head[26:30])
            (mrate,) = struct.unpack("<H", head[40:42])
            if mrate and frames * 2 * channels + 42 == total:
                return Container.MPC
    # SD2 is headerless BE PCM; metadata lives in a Mac resource fork
    # side file, so detection is extension + companion-file based.
    if path.lower().endswith(".sd2"):
        from folve_tpu_torch.audio.legacy import sniff_sd2

        if sniff_sd2(path):
            return Container.SD2
    # MP3 last: it has no container magic, only frame sync / ID3 tags.
    from folve_tpu_torch.audio.mp3 import sniff_mp3

    if sniff_mp3(path):
        return Container.MP3
    return None


_LEGACY = {Container.VOC, Container.IRCAM, Container.NIST, Container.SVX,
           Container.PVF, Container.PAF, Container.AVR, Container.WVE,
           Container.MAT, Container.HTK, Container.SDS, Container.MPC,
           Container.SD2, Container.XI}


def read_audio(path: str) -> tuple[np.ndarray, AudioInfo]:
    """Decode any supported audio file -> (float32 [frames, ch], info)."""
    container = sniff_container(path)
    if container == Container.WAV:
        return read_wav(path)
    if container == Container.FLAC:
        from folve_tpu_torch.audio.flac import read_flac

        return read_flac(path)
    if container == Container.AIFF:
        from folve_tpu_torch.audio.aiff import read_aiff

        return read_aiff(path)
    if container == Container.OGG:
        from folve_tpu_torch.audio.oggflac import sniff_ogg_codec

        codec = sniff_ogg_codec(path)
        if codec == "flac":
            from folve_tpu_torch.audio.oggflac import read_ogg_flac

            return read_ogg_flac(path)
        if codec == "opus":
            from folve_tpu_torch.audio.opus import read_opus

            return read_opus(path)
        from folve_tpu_torch.audio.ogg import read_ogg

        return read_ogg(path)
    if container == Container.AU:
        from folve_tpu_torch.audio.au import read_au

        return read_au(path)
    if container == Container.W64:
        from folve_tpu_torch.audio.w64 import read_w64

        return read_w64(path)
    if container == Container.CAF:
        from folve_tpu_torch.audio.caf import read_caf

        return read_caf(path)
    if container == Container.MP3:
        from folve_tpu_torch.audio.mp3 import read_mp3

        return read_mp3(path)
    if container in _LEGACY:
        from folve_tpu_torch.audio import legacy

        return getattr(legacy, f"read_{container.value}")(path)
    raise ValueError(f"unsupported or unrecognized audio file: {path}")


def read_audio_info(path: str) -> AudioInfo:
    container = sniff_container(path)
    if container == Container.WAV:
        return read_wav_info(path)
    if container == Container.FLAC:
        from folve_tpu_torch.audio.flac import read_flac_info

        return read_flac_info(path)
    if container == Container.AIFF:
        from folve_tpu_torch.audio.aiff import read_aiff_info

        return read_aiff_info(path)
    if container == Container.OGG:
        from folve_tpu_torch.audio.oggflac import sniff_ogg_codec

        codec = sniff_ogg_codec(path)
        if codec == "flac":
            from folve_tpu_torch.audio.oggflac import read_ogg_flac_info

            return read_ogg_flac_info(path)
        if codec == "opus":
            from folve_tpu_torch.audio.opus import read_opus_info

            return read_opus_info(path)
        from folve_tpu_torch.audio.ogg import read_ogg_info

        return read_ogg_info(path)
    if container == Container.AU:
        from folve_tpu_torch.audio.au import read_au_info

        return read_au_info(path)
    if container == Container.W64:
        from folve_tpu_torch.audio.w64 import read_w64_info

        return read_w64_info(path)
    if container == Container.CAF:
        from folve_tpu_torch.audio.caf import read_caf_info

        return read_caf_info(path)
    if container == Container.MP3:
        from folve_tpu_torch.audio.mp3 import read_mp3_info

        return read_mp3_info(path)
    if container in _LEGACY:
        from folve_tpu_torch.audio import legacy

        return getattr(legacy, f"read_{container.value}_info")(path)
    raise ValueError(f"unsupported or unrecognized audio file: {path}")


__all__ = [
    "AudioInfo",
    "Container",
    "SampleCodec",
    "WavError",
    "read_audio",
    "read_audio_info",
    "read_wav",
    "read_wav_info",
    "write_wav",
    "sniff_container",
]
