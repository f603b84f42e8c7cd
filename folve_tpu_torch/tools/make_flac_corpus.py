"""Generate a third-party-encoded FLAC conformance corpus.

Encodes PCM through **libsndfile/libFLAC** (the reference's own codec
stack: the reference's Makefile links libsndfile) via ctypes, and writes
a manifest with the exact source samples' SHA-256 so our from-scratch
decoder (native/flac_codec.cc) can be bit-validated against bytes we
did NOT produce.  Guards against self-consistent spec misreadings that
an own-encoder/own-decoder round-trip can never catch.

The corpus the tests read is vendored under tests/data/flac_corpus/ so
the test suite does not depend on libsndfile being present.  This copy
writes by default under build/folve_tpu_torch/flac_corpus/ and never
into tests/data/; pass a target directory to write elsewhere.

Content is chosen to exercise the decoder's corners: CONSTANT runs,
FIXED-predictor ramps, LPC-friendly tonal material, near-verbatim
noise, wasted bits (samples with zeroed low bits), all of 8/16/24 bps,
mono/stereo (libFLAC picks L/R, M/S, L/S, R/S adaptively), odd final
frames, multiple rates, and high-bps noise that drives RICE2
(partition escapes).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import sys
import sysconfig

import numpy as np

DEFAULT_TARGET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "folve_tpu_torch", "flac_corpus")
SF_FORMAT_FLAC = 0x170000
SF_FORMAT_PCM_S8 = 0x0001
SF_FORMAT_PCM_16 = 0x0002
SF_FORMAT_PCM_24 = 0x0003
SFM_WRITE = 0x20
SFC_SET_COMPRESSION_LEVEL = 0x1301


class _SfInfo(ctypes.Structure):
    _fields_ = [
        ("frames", ctypes.c_int64),
        ("samplerate", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("format", ctypes.c_int),
        ("sections", ctypes.c_int),
        ("seekable", ctypes.c_int),
    ]


def _load_sndfile():
    candidates = []
    for pattern in (
        os.path.join(sysconfig.get_paths()["platlib"], "pygame.libs", "libsndfile*.so*"),
        "/usr/lib/*/libsndfile.so*",
    ):
        candidates.extend(sorted(glob.glob(pattern)))
    if not candidates:
        raise RuntimeError("no libsndfile found to generate the corpus")
    # pygame's bundled libsndfile carries its deps (libFLAC, ogg ...)
    # alongside; preload them globally so the loader resolves symbols.
    libdir = os.path.dirname(candidates[0])
    for dep in sorted(glob.glob(os.path.join(libdir, "*.so*"))):
        if "sndfile" in dep:
            continue
        try:
            ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
        except OSError:
            pass
    lib = ctypes.CDLL(candidates[0])
    lib.sf_open.restype = ctypes.c_void_p
    lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_SfInfo)]
    lib.sf_write_int.restype = ctypes.c_int64
    lib.sf_write_int.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int64,
    ]
    lib.sf_command.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.sf_close.argtypes = [ctypes.c_void_p]
    lib.sf_strerror.restype = ctypes.c_char_p
    lib.sf_strerror.argtypes = [ctypes.c_void_p]
    return lib


def _encode(lib, path: str, samples: np.ndarray, rate: int, bits: int,
            compression: float) -> None:
    """samples: int32 array [frames, channels] holding bits-wide values."""
    sub = {8: SF_FORMAT_PCM_S8, 16: SF_FORMAT_PCM_16, 24: SF_FORMAT_PCM_24}[bits]
    info = _SfInfo(
        frames=0,
        samplerate=rate,
        channels=samples.shape[1],
        format=SF_FORMAT_FLAC | sub,
        sections=0,
        seekable=0,
    )
    snd = lib.sf_open(path.encode(), SFM_WRITE, ctypes.byref(info))
    if not snd:
        raise RuntimeError(lib.sf_strerror(None).decode())
    lvl = ctypes.c_double(compression)
    lib.sf_command(snd, SFC_SET_COMPRESSION_LEVEL, ctypes.byref(lvl),
                   ctypes.sizeof(lvl))
    # sf_write_int takes full-scale 32-bit values; shift bits-wide
    # samples up so libsndfile shifts them back down losslessly.
    wide = (samples.astype(np.int64) << (32 - bits)).astype(np.int32)
    flat = np.ascontiguousarray(wide.reshape(-1))
    n = lib.sf_write_int(
        snd, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), flat.size
    )
    lib.sf_close(snd)
    if n != flat.size:
        raise RuntimeError(f"short write: {n} != {flat.size}")


def _material(rng: np.random.Generator):
    """(name, frames, channels, bits, rate, compression, samples)."""
    def tone(n, ch, bits, freqs):
        t = np.arange(n)[:, None]
        y = sum(np.sin(2 * np.pi * f * t / 44100 + i) for i, f in enumerate(freqs))
        y = y / len(freqs) * 0.7
        y = np.repeat(y, ch, axis=1)
        y += rng.normal(0, 3e-4, y.shape)  # dither keeps LPC honest
        return np.round(y * ((1 << (bits - 1)) - 1)).astype(np.int32)

    def noise(n, ch, bits, amp=0.9):
        full = (1 << (bits - 1)) - 1
        return rng.integers(
            -int(full * amp), int(full * amp), (n, ch), dtype=np.int64
        ).astype(np.int32)

    out = []
    # CONSTANT + FIXED ramps + silence, odd tail.
    n = 4096 * 2 + 777
    ramp = np.zeros((n, 2), np.int32)
    ramp[1000:3000] = np.linspace(0, 20000, 2000, dtype=np.int32)[:, None]
    ramp[5000:6000] = 12345  # constant run
    out.append(("fixed_ramps_16_stereo", ramp, 16, 44100, 0.5))
    # Tonal stereo -> LPC + M/S-friendly (identical channels).
    out.append(("tonal_ms_16_stereo", tone(4096 * 3 + 1, 2, 16, [440, 1230]), 16, 44100, 1.0))
    # Decorrelated stereo (L/S-R/S territory): left tone, right delayed.
    tl = tone(4096 * 2 + 123, 1, 16, [330])
    tr = np.roll(tl, 7, axis=0) // 2 + noise(tl.shape[0], 1, 12)
    out.append(("sidestereo_16", np.concatenate([tl, tr], axis=1), 16, 48000, 1.0))
    # Wasted bits: low 4 bits zero.
    wb = (tone(4096 + 555, 2, 16, [880]) >> 4) << 4
    out.append(("wasted_bits_16_stereo", wb, 16, 44100, 0.7))
    # 24-bit noise -> big residuals, RICE2 partitions.
    out.append(("noise_24_stereo", noise(4096 * 2 + 99, 2, 24, 0.8), 24, 96000, 0.8))
    # 24-bit tonal mono.
    out.append(("tonal_24_mono", tone(4096 * 2 + 19, 1, 24, [523, 2000]), 24, 44100, 1.0))
    # 8-bit mono speech-ish.
    out.append(("lofi_8_mono", tone(4096 + 77, 1, 8, [200, 450, 1100]), 8, 22050, 0.5))
    # Full-scale 16-bit noise: near-verbatim frames.
    out.append(("verbatim_16_stereo", noise(4096 + 11, 2, 16, 0.999), 16, 44100, 0.0))
    # Single tiny frame, shorter than one block.
    out.append(("tiny_16_stereo", tone(300, 2, 16, [1000]), 16, 44100, 1.0))
    return out


def main(target: str) -> None:
    lib = _load_sndfile()
    os.makedirs(target, exist_ok=True)
    rng = np.random.default_rng(12345)
    manifest = {}
    for name, samples, bits, rate, comp in _material(rng):
        path = os.path.join(target, name + ".flac")
        _encode(lib, path, samples, rate, bits, comp)
        manifest[name + ".flac"] = {
            "frames": int(samples.shape[0]),
            "channels": int(samples.shape[1]),
            "bits": bits,
            "rate": rate,
            "pcm_sha256": hashlib.sha256(
                np.ascontiguousarray(samples.astype(np.int32)).tobytes()
            ).hexdigest(),
            "encoded_bytes": os.path.getsize(path),
        }
        print(f"  {name}.flac: {manifest[name + '.flac']['encoded_bytes']} bytes")
    with open(os.path.join(target, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"corpus written to {target}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_TARGET)
