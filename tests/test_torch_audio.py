"""The port's copy of the codecs against the JAX package's: each decodes
what the other encodes, encodes byte-equal files, and the port's native
library loader never writes under native/."""

import os
import pathlib

import numpy as np
import pytest

import folve_tpu.audio as j_audio
import folve_tpu_torch.audio as t_audio
from folve_tpu.audio import aiff as j_aiff, au as j_au, caf as j_caf
from folve_tpu.audio import flac as j_flac, w64 as j_w64, wav as j_wav
from folve_tpu.audio.types import SampleCodec as JCodec
from folve_tpu_torch.audio import aiff as t_aiff, au as t_au, caf as t_caf
from folve_tpu_torch.audio import flac as t_flac, w64 as t_w64, wav as t_wav
from folve_tpu_torch.audio.types import SampleCodec as TCodec
from folve_tpu_torch.utils import native_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
RATE = 48000


def _writers(fmt, bits):
    """(suffix, JAX writer, port writer) for one format and depth."""
    if fmt == "flac":
        return ".flac", (lambda p, x: j_flac.write_flac(p, x, RATE, bits=bits),
                         lambda p, x: t_flac.write_flac(p, x, RATE, bits=bits))
    if fmt == "wav":
        jc, tc = (getattr(c, f"PCM_{bits}") for c in (JCodec, TCodec))
        return ".wav", (lambda p, x: j_wav.write_wav(p, x, RATE, jc),
                        lambda p, x: t_wav.write_wav(p, x, RATE, tc))
    jm, tm = {"aiff": (j_aiff, t_aiff), "au": (j_au, t_au),
              "w64": (j_w64, t_w64), "caf": (j_caf, t_caf)}[fmt]
    return f".{fmt}", (lambda p, x: getattr(jm, f"write_{fmt}")(p, x, RATE, bits=bits),
                       lambda p, x: getattr(tm, f"write_{fmt}")(p, x, RATE, bits=bits))


@pytest.mark.parametrize("fmt,bits", [
    ("flac", 16), ("flac", 24), ("wav", 16), ("wav", 24), ("aiff", 16),
    ("aiff", 24), ("au", 16), ("w64", 24), ("caf", 16), ("caf", 24),
])
def test_codecs_match_the_jax_package(tmp_path, fmt, bits):
    rng = np.random.default_rng(bits)
    scale = float(1 << (bits - 1))
    x = (np.round(rng.uniform(-0.9, 0.9, (5000, 2)) * scale) / scale).astype(np.float32)
    suffix, (j_write, t_write) = _writers(fmt, bits)
    jp, tp = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    j_write(jp, x)
    t_write(tp, x)
    assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes()
    for src in (jp, tp):  # each package decodes the other's file
        a, ainfo = j_audio.read_audio(src)
        b, binfo = t_audio.read_audio(src)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert (binfo.rate, binfo.channels, binfo.frames, binfo.bits_per_sample) == (
            ainfo.rate, ainfo.channels, ainfo.frames, ainfo.bits_per_sample)
        assert binfo.container.value == ainfo.container.value
        np.testing.assert_array_equal(b, x)


def test_flac_stream_encoder_matches(tmp_path):
    """The handler's encoder: header, float and int16 writes, finish."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.5, 0.5, (9000, 2)).astype(np.float32)
    q = np.round(x * 32768).astype(np.int16)
    outs = []
    for mod in (j_flac, t_flac):
        enc = mod.FlacEncoder(rate=RATE, channels=2, bits=16, blocksize=4096,
                              total_frames_hint=18000, md5=False)
        outs.append(enc.header(None) + enc.write_float(x) + enc.write_int(q)
                    + enc.finish())
        enc.close()
    assert outs[0] == outs[1]


def _snapshot(d):
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns) for p in d.iterdir()}


def test_native_loader_never_writes_under_native(tmp_path, monkeypatch):
    """Over a private copy of native/: a stamped library there is taken
    read only, one being linked (newer than its stamp) is not, and a
    build goes to the port's own directory through make's TARGET,
    with its stamp beside it; the copy is left as it was."""
    native = tmp_path / "native"
    native.mkdir()
    for p in (ROOT / "native").iterdir():
        if p.name == "Makefile" or p.suffix in (".cc", ".h", ".inc"):
            (native / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(native_build, "_NATIVE_DIR", str(native))
    monkeypatch.setattr(native_build, "_BUILD_DIR", str(tmp_path / "build"))
    digest = native_build._source_digest()
    (native / "libfolve_native.so").write_bytes(b"\x7fELF")
    os.utime(native / "libfolve_native.so", (1e9, 1e9))
    (native / ".build_stamp").write_text(digest)
    calls = []

    def fake_make(cmd, **kw):
        calls.append(cmd)
        pathlib.Path(cmd[-1].split("=", 1)[1]).write_bytes(b"\x7fELF")

    monkeypatch.setattr(native_build.subprocess, "run", fake_make)
    before = _snapshot(native)
    assert native_build.ensure_built() == str(native / "libfolve_native.so")
    assert not calls and _snapshot(native) == before
    os.utime(native / "libfolve_native.so", (3e9, 3e9))  # relinked after its stamp
    before = _snapshot(native)
    lib = native_build.ensure_built()
    assert lib == str(tmp_path / "build" / "libfolve_native.so")
    assert (tmp_path / "build" / ".build_stamp").read_text() == digest
    (cmd,) = calls
    assert cmd[:4] == ["make", "-s", "-C", str(native)]
    assert cmd[4].startswith(f"TARGET={tmp_path / 'build'}{os.sep}")
    assert native_build.ensure_built() == lib and len(calls) == 1  # stamped now
    assert _snapshot(native) == before
